"""The port's train-state checkpoints (``lap_tpu_torch/training/checkpoints.py``)
against the semantics of ``lap_tpu/training/checkpoints.py`` on the CPU.

Exact, no tolerance: a restored state equals the saved one bit for bit
(parameters, Adam count / mu / nu, EMA or its absence, step), with and
without EMA and partitioned under ``freeze_vlm``; the steps kept under
``max_to_keep`` / ``keep_period`` are the ones the JAX ``CheckpointManager``
keeps on the same save schedule; ``initialize_checkpoint_dir`` and
``load_assets`` (the JAX package's assets item, then the plain file) behave
as JAX's. These tests save synchronously (``async_save=False``); the
asynchronous saves (the default, as JAX's) are held to the synchronous
path's bytes and to its retention, retries and atomicity at the end.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from lap_tpu_torch.models.lap_model import LAPConfig  # noqa: E402
from lap_tpu_torch.training import checkpoints  # noqa: E402
from lap_tpu_torch.training import config as port_config  # noqa: E402
from lap_tpu_torch.training import optimizer as port_opt  # noqa: E402
from lap_tpu_torch.training import train as port_train  # noqa: E402
from lap_tpu_torch.training.optimizer import AdamWState  # noqa: E402
from lap_tpu_torch.training.state import TrainState, inference_params  # noqa: E402
from torch_port_helpers import TORCH_THREADS, tiny_lap_config_kwargs  # noqa: E402

torch.set_num_threads(TORCH_THREADS)


def _tiny_config(**overrides):
    base = dict(
        name="tiny", model=LAPConfig(**tiny_lap_config_kwargs(stop_action_to_vlm_grad=True)), batch_size=2,
        ema_decay=0.9, ema_schedule_choice=port_opt.EmaScheduleChoice(kind="constant"),
        lr_schedule=port_opt.CosineDecaySchedule(warmup_steps=1, peak_lr=1e-3, decay_steps=10, decay_lr=1e-4),
    )
    base.update(overrides)
    return port_config.TrainConfig(**base)


def _trained(config, steps=1):
    trainer = port_train.build_trainer(config, device="cpu")
    trainer.run(port_train.fake_train_batch(config.model, 2, device="cpu", seed=1), steps)
    return trainer


def _assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step and a.trainable == b.trainable and a.opt_state.count == b.opt_state.count
    pa, pb = a.params, b.params
    assert set(pa) == set(pb)
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    for x, y in zip(a.opt_state.mu + a.opt_state.nu, b.opt_state.mu + b.opt_state.nu, strict=True):
        assert torch.equal(x, y)
    assert (a.ema_params is None) == (b.ema_params is None)
    if a.ema_params is not None:
        assert set(a.ema_params) == set(b.ema_params)
        assert all(torch.equal(a.ema_params[n], b.ema_params[n]) for n in a.ema_params)


@pytest.mark.parametrize("case", ["ema", "no_ema", "freeze_vlm"])
def test_train_state_round_trip_is_bit_equal(tmp_path, case):
    config = _tiny_config(**{"ema": {}, "no_ema": {"ema_decay": None}, "freeze_vlm": {"freeze_vlm": True}}[case])
    trainer = _trained(config)
    mgr = checkpoints.CheckpointManager(tmp_path / "ck", async_save=False)
    mgr.save(1, trainer.state, assets={"dataloader_process_0/dataloader_state.json": {"batches_seen": 1, "seed": 0}})
    fresh = port_train.build_trainer(config, device="cpu", init_weights=False)
    restored = checkpoints.CheckpointManager(tmp_path / "ck", async_save=False).restore(None, fresh.state)
    _assert_states_equal(trainer.state, restored)
    assert restored.opt_state.count == 1 and restored.step == 1
    if case == "freeze_vlm":
        assert 0 < len(restored.trainable) < len(restored.params)
        assert len(restored.ema_params) == len(restored.trainable)
    # params/ holds the EMA view, as a policy restores it.
    served = torch.load(tmp_path / "ck" / "1" / "params" / checkpoints.PARAMS_FILE, weights_only=True)
    view = inference_params(trainer.state)
    assert set(served) == set(view) and all(torch.equal(served[n], view[n]) for n in view)
    if case == "ema":
        assert not torch.equal(served["action_in_proj.weight"], trainer.state.params["action_in_proj.weight"])
    # The restored run continues as the original does.
    batch = port_train.fake_train_batch(config.model, 2, device="cpu", seed=5)
    assert trainer.run(batch, 1)[0]["loss"] == fresh.run(batch, 1)[0]["loss"]


def test_restore_refuses_another_freezing(tmp_path):
    mgr = checkpoints.CheckpointManager(tmp_path / "ck", async_save=False)
    mgr.save(1, _trained(_tiny_config()).state)
    other = port_train.build_trainer(_tiny_config(freeze_vlm=True), device="cpu", init_weights=False)
    with pytest.raises(ValueError, match="trainable parameters differ"):
        mgr.restore(None, other.state)
    no_ema = port_train.build_trainer(_tiny_config(ema_decay=None), device="cpu", init_weights=False)
    with pytest.raises(ValueError, match="EMA"):
        mgr.restore(None, no_ema.state)


def _small_state(step: int) -> TrainState:
    model = torch.nn.Linear(2, 2)
    names = [n for n, _ in model.named_parameters()]
    params = [p.detach() for p in model.parameters()]
    return TrainState(step=step, model=model, trainable=names,
                      opt_state=AdamWState(count=step, mu=[torch.zeros_like(p) for p in params],
                                           nu=[torch.zeros_like(p) for p in params]))


def test_a_leftover_temporary_step_is_ignored_and_removed(tmp_path):
    mgr = checkpoints.CheckpointManager(tmp_path / "ck", max_to_keep=3, async_save=False)
    mgr.save(1, _small_state(1))
    # What a kill during the step-2 save leaves: the temporary sibling.
    tmp_step = tmp_path / "ck" / f"2{checkpoints.TMP_MARK}123456"
    (tmp_step / "train_state").mkdir(parents=True)
    (tmp_step / "train_state" / "garbage").write_bytes(b"\x00\x01")
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    fresh = checkpoints.CheckpointManager(tmp_path / "ck", max_to_keep=3, async_save=False)
    assert fresh.latest_step() == 1 and not tmp_step.exists()
    assert fresh.restore(None, _small_state(0)).step == 1


@pytest.mark.parametrize("keep_period,max_to_keep", [(None, 1), (4, 1), (3, 2), (None, None)])
def test_retention_keeps_the_steps_orbax_keeps(tmp_path, keep_period, max_to_keep):
    import jax.numpy as jnp

    from lap_tpu.training.checkpoints import CheckpointManager as JaxCheckpointManager
    from lap_tpu.training.state import TrainState as JaxTrainState

    schedule = [1, 2, 3, 4, 5, 6, 8, 9, 12, 13]
    jmgr = JaxCheckpointManager(tmp_path / "jax", keep_period=keep_period, max_to_keep=max_to_keep, async_save=False)
    pmgr = checkpoints.CheckpointManager(tmp_path / "port", keep_period=keep_period, max_to_keep=max_to_keep,
                                        async_save=False)
    for step in schedule:
        jmgr.save(step, JaxTrainState(step=jnp.asarray(step), params={"w": jnp.zeros(2)},
                                      opt_state={"m": jnp.zeros(2)}, ema_params=None))
        jmgr.wait_until_finished()
        pmgr.save(step, _small_state(step))
        assert pmgr.all_steps() == jmgr.all_steps(), step


def test_save_retries_a_failed_write(tmp_path, monkeypatch):
    mgr = checkpoints.CheckpointManager(tmp_path / "ck", retry_delay_s=0.0, async_save=False)
    real_save, calls = torch.save, []

    def flaky(obj, path, *a, **kw):
        calls.append(path)
        if len(calls) == 1:
            raise OSError("disk hiccup")
        return real_save(obj, path, *a, **kw)

    monkeypatch.setattr(torch, "save", flaky)
    mgr.save(7, _small_state(7))
    assert mgr.all_steps() == [7] and len(calls) == 3  # a failed train_state, then train_state and params
    monkeypatch.setattr(torch, "save", lambda *a, **kw: (_ for _ in ()).throw(OSError("disk gone")))
    with pytest.raises(OSError, match="disk gone"):
        mgr.save(8, _small_state(8))
    assert mgr.all_steps() == [7]


def test_initialize_checkpoint_dir_cases(tmp_path):
    run_dir = tmp_path / "run"
    mgr, resuming = checkpoints.initialize_checkpoint_dir(run_dir, keep_period=None, overwrite=False, resume=False)
    assert not resuming and run_dir.is_dir()
    mgr.save(3, _small_state(3))
    mgr.wait_until_finished()  # saves are asynchronous by default
    with pytest.raises(FileExistsError):
        checkpoints.initialize_checkpoint_dir(run_dir, keep_period=None, overwrite=False, resume=False)
    mgr, resuming = checkpoints.initialize_checkpoint_dir(run_dir, keep_period=None, overwrite=False, resume=True)
    assert resuming and mgr.latest_step() == 3
    mgr, resuming = checkpoints.initialize_checkpoint_dir(run_dir, keep_period=None, overwrite=True, resume=True)
    assert not resuming and mgr.all_steps() == [] and run_dir.is_dir()
    (run_dir / "notes.txt").write_text("not a step")
    mgr, resuming = checkpoints.initialize_checkpoint_dir(run_dir, keep_period=None, overwrite=False, resume=True)
    assert not resuming  # resume with no step starts fresh


def test_assets_ride_the_save_and_the_legacy_and_jax_layouts_load(tmp_path):
    import jax.numpy as jnp

    from lap_tpu.training.checkpoints import CheckpointManager as JaxCheckpointManager
    from lap_tpu.training.state import TrainState as JaxTrainState

    assets = {
        "fake/norm_stats.json": {"norm_stats": {"state": {"mean": [0.0]}}},
        "dataloader_process_0/dataloader_state.json": {"batches_seen": 5, "seed": 3},
    }
    mgr = checkpoints.CheckpointManager(tmp_path / "ck", async_save=False)
    mgr.save(3, _small_state(3), assets=assets)
    assert mgr.load_assets(3, "dataloader_process_0/dataloader_state.json") == {"batches_seen": 5, "seed": 3}
    assert json.loads((tmp_path / "ck" / "3" / "assets" / "fake" / "norm_stats.json").read_text()) == assets[
        "fake/norm_stats.json"]
    assert mgr.load_assets(3, "missing/asset.json") is None
    # A JAX checkpoint's assets item (one JSON object), read by the port.
    jmgr = JaxCheckpointManager(tmp_path / "jax", async_save=False)
    jmgr.save(4, JaxTrainState(step=jnp.asarray(4), params={"w": jnp.zeros(2)}, opt_state={}, ema_params=None),
              assets=assets)
    jmgr.wait_until_finished()
    port_view = checkpoints.CheckpointManager(tmp_path / "jax")
    assert port_view.load_assets(4, "dataloader_process_0/dataloader_state.json") == {"batches_seen": 5, "seed": 3}
    # The legacy layout: a plain file under {step}/assets/.
    legacy = tmp_path / "jax" / "4" / "assets" / "dataloader_process_1"
    legacy.mkdir(parents=True)
    (legacy / "dataloader_state.json").write_text(json.dumps({"batches_seen": 9}))
    assert port_view.load_assets(4, "dataloader_process_1/dataloader_state.json") == {"batches_seen": 9}


def test_serving_params_file_restores_into_a_bf16_model(tmp_path):
    from lap_tpu_torch.models.lap_model import LAP

    config = LAPConfig(**tiny_lap_config_kwargs())
    source = LAP(config, device="cpu", init_seed=4)
    checkpoints.save_params(source, tmp_path / "params")
    target = LAP(config, device="cpu", init_seed=None, param_dtype=torch.bfloat16)
    checkpoints.restore_params(tmp_path / "params", target)
    got, ref = dict(target.named_parameters()), dict(source.named_parameters())
    assert all(torch.equal(got[n], ref[n].to(torch.bfloat16)) for n in ref)
    with pytest.raises(FileNotFoundError, match="export_jax_params"):
        checkpoints.restore_params(tmp_path / "nothing", target)


# ---------------------------------------------------------------------------
# Asynchronous saves (the default, as JAX's CheckpointManager(async_save=True))
# ---------------------------------------------------------------------------


def _step_bytes(step_dir):
    return {str(f.relative_to(step_dir)): f.read_bytes() for f in sorted(step_dir.rglob("*")) if f.is_file()}


def test_async_save_returns_before_the_files_exist_and_writes_the_sync_bytes(tmp_path, monkeypatch):
    """``save`` returns once the state is copied to host memory; the writer
    thread then leaves the bytes a synchronous save leaves, even though the
    live state moved on in the meantime."""
    import threading

    trainer = _trained(_tiny_config())
    sync = checkpoints.CheckpointManager(tmp_path / "sync", async_save=False)
    sync.save(1, trainer.state, assets={"a/b.json": {"x": 1}})
    release, real_save = threading.Event(), torch.save

    def gated(obj, path, *a, **kw):
        assert release.wait(timeout=60)
        return real_save(obj, path, *a, **kw)

    monkeypatch.setattr(torch, "save", gated)
    mgr = checkpoints.CheckpointManager(tmp_path / "async")
    mgr.save(1, trainer.state, assets={"a/b.json": {"x": 1}})
    assert mgr.all_steps() == [] and not (tmp_path / "async" / "1").exists()
    with torch.no_grad():  # the live state changes while the write waits
        for p in trainer.state.params.values():
            p.add_(1.0)
    release.set()
    mgr.wait_until_finished()
    assert mgr.all_steps() == [1] and mgr.last_save["step"] == 1
    assert 0 <= mgr.last_save["blocked_s"] <= mgr.last_save["seconds"] + 60
    assert _step_bytes(tmp_path / "async" / "1") == _step_bytes(tmp_path / "sync" / "1")


def test_a_second_async_save_waits_for_the_first_and_restore_waits_too(tmp_path):
    trainer = _trained(_tiny_config())
    mgr = checkpoints.CheckpointManager(tmp_path / "ck", max_to_keep=2)
    mgr.save(1, trainer.state)
    trainer.run(port_train.fake_train_batch(trainer.config.model, 2, device="cpu", seed=2), 1)
    mgr.save(2, trainer.state)
    assert mgr.all_steps() in ([1], [1, 2])  # the first is whole, the second may still be in flight
    fresh = port_train.build_trainer(trainer.config, device="cpu", init_weights=False)
    restored = mgr.restore(None, fresh.state)  # waits for step 2
    assert mgr.all_steps() == [1, 2]
    _assert_states_equal(trainer.state, restored)


def test_an_async_writer_error_raises_at_the_next_call_and_leaves_no_step(tmp_path, monkeypatch):
    """A write that dies after the train state and before the params leaves
    only its temporary sibling (removed by the next manager), never a step
    directory, and its error is raised by the next ``wait_until_finished``
    or ``save``, after the retries."""
    real_save, calls = torch.save, []

    def dies_on_params(obj, path, *a, **kw):
        calls.append(path)
        if str(path).endswith(checkpoints.PARAMS_FILE):
            raise OSError("disk gone mid-write")
        return real_save(obj, path, *a, **kw)

    monkeypatch.setattr(torch, "save", dies_on_params)
    mgr = checkpoints.CheckpointManager(tmp_path / "ck", retry_delay_s=0.0)
    mgr.save(5, _small_state(5))
    with pytest.raises(OSError, match="mid-write"):
        mgr.wait_until_finished()
    assert len(calls) == 2 * (mgr.save_retries + 1)
    assert mgr.all_steps() == [] and not (tmp_path / "ck" / "5").exists()
    assert list((tmp_path / "ck").glob(f"5{checkpoints.TMP_MARK}*"))
    mgr.wait_until_finished()  # raised once, then cleared
    mgr.save(6, _small_state(6))
    with pytest.raises(OSError, match="mid-write"):
        mgr.save(7, _small_state(7))  # the next save raises the previous write's error
    monkeypatch.setattr(torch, "save", real_save)
    assert checkpoints.CheckpointManager(tmp_path / "ck").all_steps() == []
    assert not list((tmp_path / "ck").glob(f"*{checkpoints.TMP_MARK}*"))


def test_async_retention_keeps_the_steps_the_sync_manager_keeps(tmp_path):
    schedule = [1, 2, 3, 4, 5, 6, 8, 9, 12, 13]
    sync = checkpoints.CheckpointManager(tmp_path / "sync", keep_period=4, max_to_keep=2, async_save=False)
    mgr = checkpoints.CheckpointManager(tmp_path / "async", keep_period=4, max_to_keep=2)
    for step in schedule:
        sync.save(step, _small_state(step))
        mgr.save(step, _small_state(step))
    mgr.wait_until_finished()
    assert mgr.all_steps() == sync.all_steps() == [4, 8, 12, 13]


def test_an_sgd_train_state_round_trips_and_refuses_adam(tmp_path):
    config = _tiny_config(optimizer=port_opt.SGDConfig(momentum=0.9, nesterov=True))
    trainer = _trained(config, steps=2)
    assert set(trainer.state.opt_state.buffers()) == {"trace"}
    mgr = checkpoints.CheckpointManager(tmp_path / "ck")
    mgr.save(2, trainer.state)
    fresh = port_train.build_trainer(config, device="cpu", init_weights=False)
    restored = mgr.restore(None, fresh.state)
    assert restored.opt_state.count == 2 and restored.step == 2
    for x, y in zip(trainer.state.opt_state.trace, restored.opt_state.trace, strict=True):
        assert torch.equal(x, y)
    assert all(torch.equal(trainer.state.params[n], p) for n, p in restored.params.items())
    adam = port_train.build_trainer(_tiny_config(), device="cpu", init_weights=False)
    with pytest.raises(ValueError, match="optimizer"):
        mgr.restore(None, adam.state)
