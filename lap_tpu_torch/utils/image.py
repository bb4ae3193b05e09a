"""Host-side image utilities (numpy and the native library): resize-with-pad,
uint8 conversion.

Parity with openpi.shared.image_tools as consumed by lihzha/lap clients.

Copied from ``lap_tpu/utils/image.py``; its imports point at the port's
copies, and the resize runs in the native library, not cv2.
"""

from __future__ import annotations

import numpy as np


def convert_to_uint8(img: np.ndarray) -> np.ndarray:
    """Float [0,1] or [-1,1] images -> uint8 [0,255]."""
    if np.issubdtype(img.dtype, np.floating):
        if img.min() < -0.01:  # [-1, 1]
            img = (img + 1.0) / 2.0
        img = (img * 255.0).round().clip(0, 255).astype(np.uint8)
    return img


def resized_geometry(h: int, w: int, height: int, width: int) -> tuple[int, int]:
    """(resized_h, resized_w) for aspect-preserving resize into height x width.

    Computed in float32 to match the reference's TF scalar math
    (image_utils.py:192-208): fp64 rounds differently for shapes like
    64x48 -> the reference gets 223x168 where fp64 gives 224x168, which
    shifts every pixel below the off-by-one row.
    """
    hf, wf = np.float32(h), np.float32(w)
    ratio = np.maximum(wf / np.float32(width), hf / np.float32(height))
    return int(np.floor(hf / ratio)), int(np.floor(wf / ratio))


def resize_with_pad_np(images: np.ndarray, height: int, width: int) -> np.ndarray:
    """Aspect-preserving resize + center zero-pad of uint8 HWC images,
    batched or single.

    The C++ op (``csrc/lap_native.cpp``) computes as ``cv2.resize(...,
    INTER_LINEAR)``, which the JAX package calls, bit for bit; the port
    never imports cv2. Other dtypes raise ``TypeError`` (the JAX package
    hands them to cv2)."""
    images = np.asarray(images)
    if images.shape[-3:-1] == (height, width):
        return images
    if images.dtype != np.uint8 or images.ndim not in (3, 4):
        raise TypeError(f"resize_with_pad_np takes uint8 HWC or NHWC images, got {images.dtype} {images.shape}")
    from lap_tpu_torch import native

    out = native.resize_with_pad_u8(images, height, width)
    if out is None:
        raise RuntimeError(f"the native resize is unavailable: {native.LIB_PATH} did not build or load (needs g++)")
    return out
