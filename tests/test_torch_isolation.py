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
TRAINING_MODULES = ("config", "optimizer", "state", "train", "train_step", "checkpoints", "weight_loaders", "eval")
ENTRY_POINT_MODULES = ("data.loader", "utils.cli", "training.eval", "training.weight_loaders")
QUANT_SERVING_MODULES = ("ops.int8_matmul", "ops.int4_matmul", "models.lora", "models.convert", "policies.policy")
SERVING_STACK_MODULES = (
    "policies.policy_config", "policies.batching", "serving.serve_policy", "serving.websocket_policy_server",
    "serving.websocket_client_policy", "serving.msgpack_numpy", "policies.input_transforms",
    "policies.output_transforms", "policies.model_transforms", "models.tokenizer", "models.spm", "native",
    "training.checkpoints",
)
GEMMA3_MODULES = ("models.gemma3", "models.lap_gemma3", "training.gemma3_weights")
FAST_MODULES = ("models.bpe", "models.fast_tokenizer")
DATA_MODULES = tuple(f"data.{m}" for m in (
    "tfrecord", "rlds", "rotation", "transform_helpers", "registry", "transforms_oxe", "mixtures", "norm_stats",
    "episode_pipeline", "bbox", "grounding", "vqa", "droid", "mixer"))
PARALLEL_MODULES = ("parallel", "parallel.mesh", "parallel.sharding", "parallel.tp", "training.array_utils")
JAX_LIBS = ("jax", "jaxlib", "flax", "optax", "orbax")


def test_port_imports_with_jax_blocked():
    blocked = "; ".join(f"sys.modules[{name!r}] = None" for name in (*JAX_LIBS, "scripts", "ml_dtypes"))
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
    assert {f"lap_tpu_torch.{m}" for m in QUANT_SERVING_MODULES + SERVING_STACK_MODULES + ENTRY_POINT_MODULES
            + GEMMA3_MODULES + FAST_MODULES + DATA_MODULES + PARALLEL_MODULES} <= set(mods)


def test_the_data_path_imports_no_image_library():
    """The card's host has no OpenCV or Pillow: every module of the port,
    the data pipeline's 14 included, imports with both blocked, and the
    loader, the decoder and the resize run without them."""
    blocked = "; ".join(f"sys.modules[{name!r}] = None" for name in (*JAX_LIBS, "cv2", "PIL"))
    code = (
        "import sys, pkgutil, importlib; " + blocked + "; "
        "import numpy as np; import lap_tpu_torch; "
        "[importlib.import_module(m.name) for m in pkgutil.walk_packages(lap_tpu_torch.__path__, 'lap_tpu_torch.')]; "
        "from lap_tpu_torch.data import episode_pipeline as ep; "
        "img = np.random.default_rng(0).integers(0, 255, (40, 52, 3), np.uint8); "
        "out = ep.make_image_decoder((56, 56))({'observation': {'base_0_rgb': ep.encode_jpeg(img)}}); "
        "assert out['observation']['base_0_rgb'].shape == (56, 56, 3); "
        "assert 'cv2' not in sys.modules or sys.modules['cv2'] is None"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_image_library_import_in_source(path):
    assert not re.search(r"^\s*(from|import)\s+(cv2|PIL)\b", path.read_text(), re.M)


def test_serving_stack_imports_without_its_transport_or_a_native_build():
    """The card's host has no websockets or msgpack: importing every module
    of the port, the entry point included, needs neither, and no import
    builds the native library."""
    blocked = "; ".join(f"sys.modules[{name!r}] = None" for name in (*JAX_LIBS, "websockets", "msgpack"))
    code = (
        "import sys, pkgutil, importlib; " + blocked + "; "
        "import lap_tpu_torch; "
        "[importlib.import_module(m.name) for m in pkgutil.walk_packages(lap_tpu_torch.__path__, 'lap_tpu_torch.')]; "
        "from lap_tpu_torch import native; assert native.status() == 'not tried yet', native.status(); "
        "from lap_tpu_torch.serving import serve_policy; serve_policy.parse_args(['--env', 'DEBUG'])"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_native_loader_reads_the_ports_own_source():
    from lap_tpu_torch import cuda_build, native

    assert native.SOURCE == REPO / "lap_tpu_torch" / "csrc" / "lap_native.cpp"
    assert native.LIB_PATH.parent == REPO / "lap_tpu_torch" / "_build"
    text = (REPO / "lap_tpu_torch" / "native.py").read_text()
    assert "parents[2]" not in text  # never the root csrc/ of the JAX package
    assert native.SOURCE.read_text().startswith((REPO / "csrc" / "lap_native.cpp").read_text().split("\n")[0])
    # nvcc builds the four kernel sources (and reads the .cuh headers), never the host ops' .cpp.
    from lap_tpu_torch.ops import flash_attention as fa
    from lap_tpu_torch.ops import int4_matmul, int8_matmul

    kernels = {fa.SOURCE, fa.BWD_SOURCE, int8_matmul.SOURCE, int4_matmul.SOURCE}
    assert {p.name for p in cuda_build.CSRC_DIR.glob("*.cu")} == kernels
    assert "lap_native.cpp" not in kernels and "*.cpp" not in (REPO / "lap_tpu_torch" / "cuda_build.py").read_text()


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
    # The JAX-checkpoint export tool imports lap_tpu: the port only reads its output.
    assert not re.search(r"^\s*(from|import)\s+scripts\b|import_module\(\s*[\"']scripts", text, re.M)


def test_export_tool_is_the_only_new_script_that_reads_orbax():
    text = (REPO / "scripts" / "export_jax_params.py").read_text()
    assert "from lap_tpu.training.checkpoints import restore_params" in text
    assert "lap_tpu_torch" not in re.sub(r'""".*?"""', "", text, flags=re.S)


def test_entry_points_raise_without_cuda(monkeypatch):
    from lap_tpu_torch import resolve_device
    from lap_tpu_torch.models.lap_model import LAP, LAPConfig
    from torch_port_helpers import tiny_lap_config_kwargs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LAP(LAPConfig(**tiny_lap_config_kwargs()))
    from lap_tpu_torch.serving import serve_policy

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_policy.create_policy(serve_policy.parse_args(["--env", "DEBUG"]))
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


PARALLEL_FILES = sorted((REPO / "lap_tpu_torch" / "parallel").glob("*.py")) + [
    REPO / "lap_tpu_torch" / "training" / "array_utils.py"]


@pytest.mark.parametrize("path", PARALLEL_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_parallel_modules_are_scanned_and_call_no_library_kernel(path):
    """The parallelism modules stand alone (scanned for JAX and lap_tpu
    imports above) and compute with no library kernel: collectives and
    FSDP2's sharding only, no attention or GEMM library, no compiled
    replacement of the hand-written kernels."""
    assert path in PORT_FILES
    text = path.read_text()
    for banned in (r"scaled_dot_product_attention\(", r"torch\.compile\(", r"import\s+(flash_attn|triton)\b",
                   r"(Colwise|Rowwise)Parallel\(", r"parallelize_module\(", r"torch\.(matmul|bmm)\("):
        assert not re.search(banned, text), banned
