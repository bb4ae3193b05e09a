"""Default-device rule shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return ``device``, or ``cuda`` when none is given.

    There is no silent CPU fallback: without a GPU the caller must ask for
    ``device="cpu"`` explicitly.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "lap_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def process_placement() -> tuple[int, int]:
    """(this process's index, the number of processes) of a run: JAX's
    ``jax.process_index()`` and ``jax.process_count()``. The port runs one
    process on one card until ROADMAP item 13, so this is (0, 1)."""
    return 0, 1
