"""The port stands alone: no JAX, nothing of lap_tpu, and no silent CPU
fallback."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "lap_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
TRAINING_MODULES = ("config", "optimizer", "state", "train", "train_step")
QUANT_SERVING_MODULES = ("ops.int8_matmul", "ops.int4_matmul", "models.lora", "models.convert", "policies.policy")
JAX_LIBS = ("jax", "jaxlib", "flax", "optax", "orbax")


def test_port_imports_with_jax_blocked():
    blocked = "; ".join(f"sys.modules[{name!r}] = None" for name in JAX_LIBS)
    code = (
        "import sys, pkgutil, importlib; " + blocked + "; "
        "import lap_tpu_torch; "
        "mods = [m.name for m in pkgutil.walk_packages(lap_tpu_torch.__path__, 'lap_tpu_torch.')]; "
        "[importlib.import_module(m) for m in mods]; "
        "assert not any(n == 'lap_tpu' or n.startswith('lap_tpu.') for n in sys.modules), 'lap_tpu imported'; "
        "print(' '.join(mods))"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    mods = proc.stdout.split()
    assert len(mods) >= 12 + len(TRAINING_MODULES)
    assert {f"lap_tpu_torch.{m}" for m in QUANT_SERVING_MODULES} <= set(mods)


def test_training_sources_are_scanned():
    scanned = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for name in TRAINING_MODULES:
        assert f"lap_tpu_torch/training/{name}.py" in scanned
    assert "lap_tpu_torch/models/metrics.py" in scanned


def test_dequant_wrappers_take_the_plain_versions_only_on_cpu_tensors():
    from lap_tpu_torch.ops import int4_matmul, int8_matmul

    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 512), generator=g).to(torch.bfloat16)
    w = torch.randn((512, 64), generator=g)
    before = (int8_matmul.launches, int4_matmul.launches)
    w8 = int8_matmul.quantize_int8(w)
    w4 = int4_matmul.quantize_int4(w)
    assert torch.equal(int8_matmul.int8_matmul(x, *w8), int8_matmul.int8_matmul_plain(x, *w8))
    assert torch.equal(int4_matmul.int4_matmul(x, *w4), int4_matmul.int4_matmul_plain(x, *w4))
    assert (int8_matmul.launches, int4_matmul.launches) == before
    with pytest.raises(ValueError):
        int8_matmul.int8_matmul(x[:, :100], *w8)


@pytest.mark.parametrize("path", sorted((REPO / "lap_tpu_torch" / "csrc").glob("*.cu*")),
                         ids=lambda p: p.name)
def test_kernel_sources_call_no_library_kernel(path):
    """Hand-written kernels: no cuBLAS, cuDNN, CUTLASS device GEMM or PyTorch header."""
    text = path.read_text()
    assert not re.search(r"#include\s*[<\"](cublas|cudnn|cutlass|torch|ATen|c10)", text)
    assert "mma.sync" in text or path.suffix == ".cu" and "flash_attention_common.cuh" in text


def test_trainer_entry_point_raises_without_cuda(monkeypatch):
    from lap_tpu_torch.training.config import get_config
    from lap_tpu_torch.training.train import build_trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_trainer(get_config("debug"))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_lap_tpu_import_in_source(path):
    text = path.read_text()
    assert not re.search(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|orbax)\b", text, re.M)
    assert not re.search(r"lap_tpu\.|import lap_tpu\b", text)


def test_entry_points_raise_without_cuda(monkeypatch):
    from lap_tpu_torch import resolve_device
    from lap_tpu_torch.models.lap_model import LAP, LAPConfig
    from torch_port_helpers import tiny_lap_config_kwargs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LAP(LAPConfig(**tiny_lap_config_kwargs()))
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", script)
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=300
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
