"""The port's ``serve_policy`` entry point on the CPU: ``create_policy`` for
each preset on a fabricated checkpoint (the presets' configs overridden by
``--config debug``, the dummy widths), the DEBUG preset without one, the
refusals, and websocket round trips against the port's policy on localhost,
in process and through ``python -m lap_tpu_torch.serving.serve_policy
--device cpu``. The transport needs ``websockets`` and ``msgpack``, which
this host has. Checks are on shapes, finiteness and metadata: the numbers
are held against the JAX package in ``test_torch_serving_stack.py``.
"""

import asyncio
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu_torch.models.lap_model import LAP  # noqa: E402
from lap_tpu_torch.policies import model_transforms as mt  # noqa: E402
from lap_tpu_torch.policies.batching import BatchingPolicy  # noqa: E402
from lap_tpu_torch.policies.policy import ARPolicy, Policy, PolicyRecorder  # noqa: E402
from lap_tpu_torch.serving import serve_policy  # noqa: E402
from lap_tpu_torch.training import checkpoints, config  # noqa: E402
from torch_port_helpers import TORCH_THREADS  # noqa: E402

torch.set_num_threads(TORCH_THREADS)
REPO = Path(__file__).resolve().parents[1]


def _obs(res=56):
    rng = np.random.default_rng(0)
    return {
        "observation": {
            "base_0_rgb": rng.integers(0, 255, (res, res, 3), np.uint8),
            "left_wrist_0_rgb": rng.integers(0, 255, (res, res, 3), np.uint8),
            "state": np.zeros(7, np.float32),
        },
        "prompt": "pick up the cup",
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt")
    checkpoints.save_params(LAP(config.get_config("debug").model, device="cpu", init_seed=3), path / "params")
    stats = mt.NormStats(mean=np.zeros(7, np.float32), std=np.ones(7, np.float32), q01=-np.ones(7, np.float32),
                         q99=np.ones(7, np.float32))
    checkpoints.save_norm_stats(path / "assets" / "fake" / "norm_stats.json", {"state": stats, "actions": stats})
    return path


def _args(*argv):
    return serve_policy.parse_args(["--device", "cpu", *argv])


@pytest.mark.parametrize("env,cls", [("LAP", Policy), ("LAP_AR", ARPolicy), ("LAP_LIBERO", Policy), ("DEBUG", Policy)])
def test_create_policy_for_each_preset(ckpt, env, cls):
    policy = serve_policy.create_policy(
        _args("--env", env, "--config", "debug", "--checkpoint_dir", str(ckpt), "--allow_test_vocab"))
    assert type(policy) is cls
    assert policy.metadata == {"config": "debug", "mode": "ar" if cls is ARPolicy else "flow"}
    if cls is ARPolicy:
        policy._max_decoding_steps = 4
    out = policy.infer(_obs())
    assert np.isfinite(np.asarray(out["actions"])).all()
    assert out["actions"].shape == ((4, 7) if cls is Policy else out["actions"].shape)


def test_create_policy_wraps_the_batcher_and_the_recorder(ckpt, tmp_path):
    policy = serve_policy.create_policy(_args(
        "--env", "LAP", "--config", "debug", "--checkpoint_dir", str(ckpt), "--allow_test_vocab",
        "--max_batch", "2", "--batch_window_ms", "1", "--record_dir", str(tmp_path), "--token_bucket", "64"))
    assert isinstance(policy, PolicyRecorder) and isinstance(policy._policy, BatchingPolicy)
    assert policy._policy._policy._token_bucket == 64
    out = policy.infer(_obs())
    assert out["policy_timing"]["batch_size"] == 1 and out["actions"].shape == (4, 7)
    assert [p.name for p in tmp_path.iterdir()] == ["step_000000.npz"]
    policy._policy.close()


def test_debug_preset_without_a_checkpoint_and_its_refusals(ckpt):
    policy = serve_policy.create_policy(_args("--env", "DEBUG", "--default_prompt", "pick up the block"))
    assert policy.metadata == {"config": "debug", "mode": "flow"}
    assert policy.infer(_obs())["actions"].shape == (4, 7)
    for flag in (["--quantize", "int8"], ["--serve_tp", "2"]):
        with pytest.raises(SystemExit, match="never restores"):
            serve_policy.create_policy(_args("--env", "DEBUG", *flag))
    with pytest.raises(RuntimeError, match="TEST tokenizer"):
        serve_policy.create_policy(_args("--env", "LAP", "--config", "debug", "--checkpoint_dir", str(ckpt)))


def test_websocket_round_trip_in_process():
    from lap_tpu_torch.serving.websocket_client_policy import WebsocketClientPolicy
    from lap_tpu_torch.serving.websocket_policy_server import WebsocketPolicyServer

    policy = serve_policy.create_policy(_args("--env", "DEBUG"))
    port = _free_port()
    server = WebsocketPolicyServer(policy, host="127.0.0.1", port=port)
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(server.run())
        except RuntimeError:  # the loop stopped under the server
            pass

    threading.Thread(target=run, daemon=True).start()
    deadline = time.time() + 60
    while True:
        try:
            client = WebsocketClientPolicy(host="127.0.0.1", port=port)
            break
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)
    assert client.get_server_metadata() == {"config": "debug", "mode": "flow"}
    for _ in range(2):  # the second request reuses the connection
        result = client.infer(_obs())
        assert result["actions"].shape == (4, 7) and np.isfinite(result["actions"]).all()
        assert result["policy_timing"]["infer_ms"] > 0
    client.close()
    loop.call_soon_threadsafe(loop.stop)


def test_serve_policy_module_serves_a_round_trip(tmp_path):
    from lap_tpu_torch.serving.websocket_client_policy import WebsocketClientPolicy

    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "lap_tpu_torch.serving.serve_policy", "--env", "DEBUG", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port), "--record_dir", str(tmp_path / "rec")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.time() + 120
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"server died:\n{proc.stdout.read()[-3000:]}")
            try:
                client = WebsocketClientPolicy(host="127.0.0.1", port=port)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.5)
        assert client.get_server_metadata()["config"] == "debug"
        result = client.infer(_obs())
        assert result["actions"].shape == (4, 7) and np.isfinite(result["actions"]).all()
        client.close()
        assert any((tmp_path / "rec").iterdir())
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)


def test_entry_point_raises_without_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_policy.create_policy(serve_policy.parse_args(["--env", "DEBUG"]))
    assert isinstance(serve_policy.create_policy(_args("--env", "DEBUG")), Policy)


def test_serve_policy_module_serves_tensor_parallel_over_two_ranks(ckpt):
    """``--serve_tp 2``: the command starts its two ranks (gloo with
    ``--device cpu``), each restores its slices of the checkpoint, rank 0
    serves on the websocket and rank 1 follows its model calls."""
    from lap_tpu_torch.serving.websocket_client_policy import WebsocketClientPolicy

    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "lap_tpu_torch.serving.serve_policy", "--env", "LAP", "--config", "debug",
         "--checkpoint_dir", str(ckpt), "--allow_test_vocab", "--device", "cpu", "--serve_tp", "2",
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True,  # the ranks are its children: one signal stops them all
    )
    try:
        deadline = time.time() + 120
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"server died:\n{proc.stdout.read()[-3000:]}")
            try:
                client = WebsocketClientPolicy(host="127.0.0.1", port=port)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.5)
        assert client.get_server_metadata()["config"] == "debug"
        for _ in range(2):
            result = client.infer(_obs())
            assert result["actions"].shape == (4, 7) and np.isfinite(result["actions"]).all()
        client.close()
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    assert "following rank 0's model calls" in proc.stdout.read()
