"""The port's copies of the data modules against the reference's TF data
plane: every test of ``tests/test_ref_parity.py`` (rotation, gripper
helpers, language-action windows, the per-dataset standardizations and the
long-tail sweep, the image decode/resize/rotation path, the norm-stats
merge and quantiles, chunking, the instruction fills), run again here with
the modules it reads swapped for the port's.

The tests are the JAX package's own, imported unchanged, so their
tolerances are theirs (``TOL``, ``ANG`` and the image tolerances of
``test_ref_parity.py``). The swap replaces ``lap_tpu.data.*``,
``lap_tpu.native``, ``lap_tpu.policies.model_transforms`` and
``lap_tpu.utils.image`` in ``sys.modules`` (the tests import inside their
bodies) and the module's own ``rotation``, ``th`` and
``get_dataset_config``.
"""

import importlib
import sys

import pytest

pytest.importorskip("torch")

import test_ref_parity as _ref  # noqa: E402
from test_ref_parity import *  # noqa: E402,F401,F403 - the reference tests and fixtures, collected again here

SWAPPED = (
    "native", "data.rotation", "data.transform_helpers", "data.transforms_oxe", "data.registry",
    "data.episode_pipeline", "data.helpers", "data.norm_stats", "policies.model_transforms", "utils.image",
)


@pytest.fixture(autouse=True)
def _port_modules(monkeypatch):
    for name in SWAPPED:
        port = importlib.import_module(f"lap_tpu_torch.{name}")
        monkeypatch.setitem(sys.modules, f"lap_tpu.{name}", port)
        parent, _, attr = f"lap_tpu.{name}".rpartition(".")
        monkeypatch.setattr(importlib.import_module(parent), attr, port, raising=False)
    monkeypatch.setattr(_ref, "rotation", sys.modules["lap_tpu.data.rotation"])
    monkeypatch.setattr(_ref, "th", sys.modules["lap_tpu.data.transform_helpers"])
    monkeypatch.setattr(_ref, "get_dataset_config", sys.modules["lap_tpu.data.registry"].get_dataset_config)


def test_the_swap_reaches_the_port():
    from lap_tpu.data.episode_pipeline import make_image_decoder
    from lap_tpu.data.norm_stats import merge_norm_stats

    assert make_image_decoder.__module__ == "lap_tpu_torch.data.episode_pipeline"
    assert merge_norm_stats.__module__ == "lap_tpu_torch.data.norm_stats"
    assert _ref.get_dataset_config("libero_10_no_noops").standardize_fn.__module__ == "lap_tpu_torch.data.transforms_oxe"
