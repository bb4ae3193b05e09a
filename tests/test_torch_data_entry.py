"""The training entry point of the port on RLDS data, on the CPU:
``python -m lap_tpu_torch.training.train lap_libero`` at dummy width from a
``libero_finetune`` mixture written to disk.

Two steps from the mixture, a save at the last: the run's norm stats (the
pipeline's, which ``Normalize`` applied to its batches) are the step's
``assets/libero/norm_stats.json``, equal to the JAX package's stats pass
over the same files, and the loader's cursor is saved beside them. A run
resumed from that step takes its first batch where the first run stopped:
its loss equals the loss of the batch the first run's stream gives next, on
the first run's state, bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu.data import mixer as jax_mixer  # noqa: E402
from lap_tpu.data import rlds as jax_rlds  # noqa: E402
from lap_tpu.training import config as jax_config  # noqa: E402
from lap_tpu_torch.data.episode_pipeline import encode_jpeg  # noqa: E402
from lap_tpu_torch.training import checkpoints  # noqa: E402
from lap_tpu_torch.training import train as port_train  # noqa: E402
from lap_tpu_torch.training.train_step import step_generator  # noqa: E402
from torch_port_helpers import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)

LIBERO = ("libero_10_no_noops", "libero_goal_no_noops", "libero_object_no_noops", "libero_spatial_no_noops")
SMALL = ["--model.paligemma_variant", "dummy", "--model.action_expert_variant", "dummy", "--model.siglip_variant",
         "dummy", "--model.dtype", "float32", "--model.image_resolution", "56,56", "--batch_size", "2",
         "--data.shuffle_buffer_size", "16", "--log_interval", "1", "--weight_loader.kind", "none", "--device", "cpu"]


@pytest.fixture(scope="module")
def libero_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("libero_entry")
    rng = np.random.default_rng(5)
    t = 12
    for i, name in enumerate(LIBERO):
        episodes = []
        for k in range(3):
            frames = [encode_jpeg(rng.integers(0, 255, (48, 48, 3), np.uint8)) for _ in range(2 * t)]
            state = np.concatenate([rng.uniform(-0.3, 0.3, (t, 3)), rng.uniform(-0.5, 0.5, (t, 3)),
                                    rng.uniform(0, 0.04, (t, 2))], -1).astype(np.float32)
            action = np.concatenate([rng.uniform(-0.02, 0.02, (t, 6)), rng.choice([-1.0, 1.0], (t, 1))], -1)
            episodes.append({"steps": {
                "observation": {"image": frames[:t], "wrist_image": frames[t:], "state": state},
                "action": action.astype(np.float32), "language_instruction": [f"task {i} {k}"] * t}})
        jax_rlds.write_rlds_dataset(root, name, episodes)
    return root


def test_lap_libero_trains_two_steps_from_rlds_and_saves_its_norm_stats(libero_dir, tmp_path):
    args = ["lap_libero", *SMALL, "--data.rlds_data_dir", str(libero_dir), "--exp_name", "rlds",
            "--checkpoint_base_dir", str(tmp_path)]
    first = port_train.main([*args, "--num_train_steps", "2"])
    try:
        assert first.trainer.state.step == 2 and np.isfinite(first.metrics["loss"])
        assert len(first.timings["data_wait_s"]) == 2 and len(first.timings["step_ms"]) == 2
        step_dir = first.checkpoints.step_dir(2)
        saved = checkpoints.load_norm_stats(step_dir / "assets", "libero")
        assert saved is not None and {"actions", "state"} <= set(saved)
        # The assets are the loader's stats, and equal JAX's pass over the files.
        jc = jax_config.get_config("lap_libero")
        jc = dataclasses.replace(jc, data=dataclasses.replace(jc.data, rlds_data_dir=str(libero_dir)))
        want, _ = jax_mixer.compute_mixture_norm_stats(jc, jax_mixer.get_mixture("libero_finetune"))
        for key in ("actions", "state"):
            assert saved[key].to_dict() == first.loader.norm_stats[key].to_dict()
            np.testing.assert_array_equal(saved[key].q99, np.asarray(want[key].q99, np.float32))
            np.testing.assert_array_equal(saved[key].mean, np.asarray(want[key].mean, np.float32))
        assert first.checkpoints.load_assets(2, port_train.LOADER_STATE)["batches_seen"] == 2
        # The next batch of the live stream, on the saved state, with step 2's randomness.
        batch = next(first.data_iter)
        state = first.trainer.state
        loss, _ = first.trainer.model.compute_loss(
            *batch, train=True, generator=step_generator(first.trainer.config.seed, state.step, torch.device("cpu")))
        next_loss = loss.item()
    finally:
        first.close()
    resumed = port_train.main([*args, "--num_train_steps", "3", "--resume", "true"])
    resumed.close()
    assert resumed.metrics["loss"] == next_loss
