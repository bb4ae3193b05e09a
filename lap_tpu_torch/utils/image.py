"""Host-side image utilities (numpy/cv2): resize-with-pad, uint8 conversion.

Parity with openpi.shared.image_tools as consumed by lihzha/lap clients.

Copied from ``lap_tpu/utils/image.py``; its imports point at the port's
copies.
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
    """Aspect-preserving resize + center zero-pad, batched or single.

    Dispatches to the C++ op (csrc/lap_native.cpp) for uint8 inputs; falls
    back to cv2 otherwise."""
    images = np.asarray(images)
    if images.shape[-3:-1] == (height, width):
        return images
    try:
        import cv2  # SIMD resize: fastest path when available
    except ImportError:
        if images.dtype == np.uint8 and images.ndim in (3, 4):
            from lap_tpu_torch import native

            out = native.resize_with_pad_u8(images, height, width)
            if out is not None:
                return out
        raise

    single = images.ndim == 3
    if single:
        images = images[None]
    h, w = images.shape[-3], images.shape[-2]
    rh, rw = resized_geometry(h, w, height, width)
    out = np.zeros((*images.shape[:-3], height, width, images.shape[-1]), dtype=images.dtype)
    y0 = (height - rh) // 2
    x0 = (width - rw) // 2
    flat = images.reshape(-1, h, w, images.shape[-1])
    out_flat = out.reshape(-1, height, width, images.shape[-1])
    for i in range(flat.shape[0]):
        out_flat[i, y0 : y0 + rh, x0 : x0 + rw] = cv2.resize(
            flat[i], (rw, rh), interpolation=cv2.INTER_LINEAR
        ).reshape(rh, rw, -1)
    return out[0] if single else out
