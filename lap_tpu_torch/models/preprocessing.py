"""Image preprocessing and train-time augmentation (port of
``lap_tpu/models/preprocessing.py``).

Aspect-preserving resize-with-pad, then for training batches a per-sample
pipeline of random crop (95 %) -> resize back -> rotate (+-5 degrees) ->
colour jitter (0.2 / 0.2 / 0.2), skipped per sample by ``vqa_mask`` and for
wrist cameras when ``aug_wrist_image`` is false.

JAX draws the crop offsets, the angle and the jitter factors from split keys
inside the pipeline. Here they are explicit tensors (``AugmentParams``), drawn
from a ``torch.Generator`` by default, so a test can feed both frameworks the
same values. Edge rules held from JAX: ``jax.image.resize`` bilinear uses
half-pixel centres with weights renormalised at the border (PyTorch's
``align_corners=False`` with ``antialias=True``); the rotation samples like
``map_coordinates(order=1, mode="constant")``: a bilinear tap outside the
image contributes zero.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping, Sequence

import torch
import torch.nn.functional as F

from lap_tpu_torch.models.types import IMAGE_KEYS, IMAGE_RESOLUTION, CoTObservation, _to_float_image

CROP_FRACTION = 0.95
MAX_ROTATION_DEGREES = 5.0
JITTER_STRENGTH = 0.2


def _resize_bilinear(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[N, H, W, C] -> [N, height, width, C], as ``jax.image.resize`` bilinear."""
    x = images.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).to(images.dtype)


def resize_with_pad(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Resize [..., H, W, C] preserving aspect ratio, zero-padding the rest."""
    h, w = images.shape[-3], images.shape[-2]
    if (h, w) == (height, width):
        return images
    ratio = max(h / height, w / width)
    rh, rw = int(h / ratio), int(w / ratio)
    lead = images.shape[:-3]
    x = _resize_bilinear(images.reshape(-1, h, w, images.shape[-1]), rh, rw)
    pad_h0 = (height - rh) // 2
    pad_w0 = (width - rw) // 2
    x = F.pad(x, (0, 0, pad_w0, width - rw - pad_w0, pad_h0, height - rh - pad_h0))
    return x.reshape(*lead, height, width, images.shape[-1])


@dataclasses.dataclass(frozen=True)
class AugmentParams:
    """Per-sample random values of one camera's augmentation, each [B]."""

    crop_y: torch.Tensor  # int, top row of the crop
    crop_x: torch.Tensor  # int, left column of the crop
    angle: torch.Tensor  # radians
    brightness: torch.Tensor  # factors 1 + U(-0.2, 0.2)
    contrast: torch.Tensor
    saturation: torch.Tensor

    @classmethod
    def draw(cls, batch: int, height: int, width: int, *, generator=None, device=None):
        ch, cw = int(height * CROP_FRACTION), int(width * CROP_FRACTION)
        kw = dict(generator=generator, device=device)

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand((batch,), dtype=torch.float32, **kw)

        return cls(
            crop_y=torch.randint(0, height - ch + 1, (batch,), **kw),
            crop_x=torch.randint(0, width - cw + 1, (batch,), **kw),
            angle=uniform(-MAX_ROTATION_DEGREES, MAX_ROTATION_DEGREES) * (math.pi / 180.0),
            brightness=1.0 + uniform(-JITTER_STRENGTH, JITTER_STRENGTH),
            contrast=1.0 + uniform(-JITTER_STRENGTH, JITTER_STRENGTH),
            saturation=1.0 + uniform(-JITTER_STRENGTH, JITTER_STRENGTH),
        )


def _random_crop_resize(imgs: torch.Tensor, crop_y: torch.Tensor, crop_x: torch.Tensor):
    b, h, w, _ = imgs.shape
    ch, cw = int(h * CROP_FRACTION), int(w * CROP_FRACTION)
    rows = crop_y.long()[:, None] + torch.arange(ch, device=imgs.device)[None, :]
    cols = crop_x.long()[:, None] + torch.arange(cw, device=imgs.device)[None, :]
    batch = torch.arange(b, device=imgs.device)[:, None, None]
    crop = imgs[batch, rows[:, :, None], cols[:, None, :]]  # [B, ch, cw, C]
    return _resize_bilinear(crop, h, w)


def _bilinear_rotate(imgs: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate each [H, W, C] image by its angle (radians) about its centre."""
    b, h, w, _ = imgs.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=imgs.device),
        torch.arange(w, dtype=torch.float32, device=imgs.device),
        indexing="ij",
    )
    cos, sin = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    sy = cy + (yy - cy) * cos - (xx - cx) * sin
    sx = cx + (yy - cy) * sin + (xx - cx) * cos
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0, sx - x0
    batch = torch.arange(b, device=imgs.device)[:, None, None]
    out = torch.zeros_like(imgs)
    for dy, weight_y in ((0, 1 - wy), (1, wy)):
        for dx, weight_x in ((0, 1 - wx), (1, wx)):
            yi, xi = (y0 + dy).long(), (x0 + dx).long()
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            tap = imgs[batch, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
            out = out + torch.where(valid, weight_y * weight_x, 0.0)[..., None] * tap
    return out


def _color_jitter(imgs, brightness, contrast, saturation):
    """Brightness / contrast / saturation jitter on [0, 1] images."""
    imgs = imgs * brightness[:, None, None, None]
    mean = imgs.mean(dim=(-3, -2, -1), keepdim=True)
    imgs = mean + (imgs - mean) * contrast[:, None, None, None]
    gray = imgs.mean(dim=-1, keepdim=True)
    imgs = gray + (imgs - gray) * saturation[:, None, None, None]
    return imgs.clamp(0.0, 1.0)


def augment_images(images: torch.Tensor, params: AugmentParams) -> torch.Tensor:
    """Augment a batch [B, H, W, C] in [-1, 1]; returns the same range."""
    imgs = images / 2.0 + 0.5
    imgs = _random_crop_resize(imgs, params.crop_y, params.crop_x)
    imgs = _bilinear_rotate(imgs, params.angle.to(imgs.dtype))
    imgs = _color_jitter(imgs, params.brightness, params.contrast, params.saturation)
    return imgs * 2.0 - 1.0


def preprocess_observation(
    observation: CoTObservation,
    *,
    train: bool = False,
    image_keys: Sequence[str] = IMAGE_KEYS,
    image_resolution: tuple[int, int] = IMAGE_RESOLUTION,
    aug_wrist_image: bool = True,
    enable_image_augmentation: bool = True,
    vqa_mask: torch.Tensor | None = None,
    aug_params: Mapping[str, AugmentParams] | None = None,
    generator: torch.Generator | None = None,
) -> CoTObservation:
    """Convert images to [-1, 1], resize if needed, augment (train only),
    default the image masks. ``aug_params`` gives a camera's random values;
    a camera without an entry draws its own from ``generator``."""
    batch_shape = observation.state.shape[:-1]
    out_images = {}
    for key in image_keys:
        image = _to_float_image(observation.images[key])
        if tuple(image.shape[-3:-1]) != tuple(image_resolution):
            image = resize_with_pad(image, *image_resolution)
        if train and enable_image_augmentation and (aug_wrist_image or "wrist" not in key):
            params = (aug_params or {}).get(key)
            if params is None:
                params = AugmentParams.draw(
                    image.shape[0], *image_resolution, generator=generator, device=image.device
                )
            aug = augment_images(image, params)
            if vqa_mask is not None:
                image = torch.where(vqa_mask[:, None, None, None], image, aug)
            else:
                image = aug
        out_images[key] = image
    out_masks = {}
    for key in out_images:
        if key in observation.image_masks:
            out_masks[key] = torch.as_tensor(observation.image_masks[key], dtype=torch.bool)
        else:
            out_masks[key] = torch.ones(batch_shape, dtype=torch.bool, device=observation.state.device)
    return observation.replace(images=out_images, image_masks=out_masks)
