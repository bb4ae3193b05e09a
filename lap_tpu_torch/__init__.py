"""PyTorch/CUDA port of lap_tpu for one NVIDIA H100.

The JAX package ``lap_tpu`` is the reference; this package mirrors its layout
(``ops/``, ``models/``, ``policies/``, ``training/``) and imports nothing of it or of JAX.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from lap_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
