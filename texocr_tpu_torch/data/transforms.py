"""Host-side image preprocessing.

- ``affine_scale_aug``: the training-time augmentation, a random scale about
  the centre (0.85-1.05, bilinear, white fill), in torch on the host, since the
  machine with the card has no PIL. It samples where the JAX package's PIL
  ``Image.transform(AFFINE, BILINEAR, fillcolor=255)`` samples: output pixel
  centres mapped through the inverse scale, neighbours clamped at the border,
  white where the sample point falls outside the image, and the result
  truncated to uint8 as PIL stores it. The scale is drawn from the numpy
  generator as the JAX package draws it.
- ``to_model_array``: a uint8 image (or a PIL image) -> float32 (H, W, 1) in
  [0, 1], grayscale and inverted (ink 1, background 0).
- ``preprocess``: the same on a batch of raw uint8 images on their own
  device, centre-padded to the render rule's canvas multiples.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from texocr_tpu_torch.utils import pad_to_multiple

# ITU-R 601 luma weights, what torchvision's Grayscale uses.
_LUMA = np.array([0.2989, 0.587, 0.114], dtype=np.float32)
# Bilinear weights summed in another order than PIL's can fall a rounding
# error short of an exact integer, which truncation would drop by one.
_TRUNC_EPS = 1e-9


def scale_image(arr: np.ndarray, s: float) -> np.ndarray:
    """(H, W) uint8 scaled by ``s`` about its centre, bilinear, white fill."""
    h, w = arr.shape
    # float64, as PIL computes: its truncation to uint8 then lands on the same
    # integer but where a sum lies within _TRUNC_EPS below one.
    x = torch.from_numpy(arr).double()[None, None]
    # Normalised output pixel centres, scaled: the input point PIL samples.
    theta = torch.tensor([[[1.0 / s, 0.0, 0.0], [0.0, 1.0 / s, 0.0]]], dtype=torch.float64)
    grid = F.affine_grid(theta, [1, 1, h, w], align_corners=False)
    out = F.grid_sample(x, grid, mode="bilinear", padding_mode="border", align_corners=False)
    outside = ((grid < -1) | (grid >= 1)).any(-1)[None]
    out = torch.where(outside, 255.0, out)
    return (out[0, 0] + _TRUNC_EPS).clamp(0, 255).to(torch.uint8).numpy()


def affine_scale_aug(arr: np.ndarray, rng: np.random.Generator,
                     scale_range: Tuple[float, float] = (0.85, 1.05)) -> np.ndarray:
    """Random centre scale of a (H, W) uint8 image, white fill, bilinear."""
    return scale_image(arr, float(rng.uniform(*scale_range)))


def to_model_array(img) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) array, or a PIL image -> float32 (H, W, 1)
    in [0, 1], grayscale, inverted."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        gray = arr.astype(np.float32) / 255.0
    else:
        rgb = arr[..., :3].astype(np.float32) / 255.0
        gray = rgb @ _LUMA
    return (1.0 - gray)[..., None]


def img_transform(arr: np.ndarray, rng: Optional[np.random.Generator] = None,
                  augment: bool = False) -> np.ndarray:
    """The full host transform of a (H, W) uint8 image; ``augment`` applies
    the random scale first."""
    if augment:
        arr = affine_scale_aug(arr, rng if rng is not None else np.random.default_rng())
    return to_model_array(arr)


def preprocess(raw: torch.Tensor, patch_size: int = 16, width_multiple: int = 64) -> torch.Tensor:
    """uint8 (B, H, W) or (B, H, W, C) -> float32 (B, H', W', 1) on the same
    device: grayscale (luma weights for 3 or more channels, else the first),
    inverted, and centre-padded with background (0) to H' a multiple of
    ``patch_size`` and W' of ``width_multiple``."""
    x = raw.float() / 255.0
    if x.dim() == 4 and x.shape[-1] >= 3:
        x = x[..., :3] @ torch.from_numpy(_LUMA).to(x.device)
    elif x.dim() == 4:
        x = x[..., 0]
    x = 1.0 - x
    _, h, w = x.shape
    pad_h = pad_to_multiple(h, patch_size) - h
    pad_w = pad_to_multiple(w, width_multiple) - w
    x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
    return x[..., None]
