"""Inference-time image preprocessing (port of the ``train=False`` branch of
``lap_tpu/models/preprocessing.py``). Train-time augmentation is not ported
yet.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F

from lap_tpu_torch.models.types import IMAGE_KEYS, IMAGE_RESOLUTION, CoTObservation, _to_float_image


def resize_with_pad(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Resize [..., H, W, C] preserving aspect ratio, zero-padding the rest.

    Bilinear with antialiasing, as ``jax.image.resize`` defaults to.
    """
    h, w = images.shape[-3], images.shape[-2]
    if (h, w) == (height, width):
        return images
    ratio = max(h / height, w / width)
    rh, rw = int(h / ratio), int(w / ratio)
    lead = images.shape[:-3]
    x = images.reshape(-1, h, w, images.shape[-1]).permute(0, 3, 1, 2)
    x = F.interpolate(x.float(), size=(rh, rw), mode="bilinear", align_corners=False, antialias=True)
    pad_h0 = (height - rh) // 2
    pad_w0 = (width - rw) // 2
    x = F.pad(x, (pad_w0, width - rw - pad_w0, pad_h0, height - rh - pad_h0))
    return x.permute(0, 2, 3, 1).reshape(*lead, height, width, images.shape[-1]).to(images.dtype)


def preprocess_observation(
    observation: CoTObservation,
    *,
    image_keys: Sequence[str] = IMAGE_KEYS,
    image_resolution: tuple[int, int] = IMAGE_RESOLUTION,
) -> CoTObservation:
    """Convert images to [-1, 1], resize if needed, default the image masks."""
    batch_shape = observation.state.shape[:-1]
    out_images = {}
    for key in image_keys:
        image = _to_float_image(observation.images[key])
        if tuple(image.shape[-3:-1]) != tuple(image_resolution):
            image = resize_with_pad(image, *image_resolution)
        out_images[key] = image
    out_masks = {}
    for key in out_images:
        if key in observation.image_masks:
            out_masks[key] = torch.as_tensor(observation.image_masks[key], dtype=torch.bool)
        else:
            out_masks[key] = torch.ones(batch_shape, dtype=torch.bool, device=observation.state.device)
    return observation.replace(images=out_images, image_masks=out_masks)
