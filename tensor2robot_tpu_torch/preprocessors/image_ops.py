"""Image preprocessing ops: crops, flips, photometric and depth distortions.

Counterpart of `tensor2robot_tpu.preprocessors.image_ops`. Every op works
on a batched [B, H, W, C] float image in [0, 1] (NHWC, the feature
layout) on whatever device it lies on, and takes its random draws as
arguments: crop offsets, brightness deltas, saturation and contrast
factors, hue angles, noise. So a test can hand it the JAX package's
draws. The `draw_*` functions draw them from a `torch.Generator` (on the
CPU, then moved to the image's device, so the card and the CPU see the
same numbers) in the order the JAX package splits its keys:
`crop_resize_distort` splits into crop and distortion keys, the crop key
into tops and lefts, the distortion key five ways (brightness,
saturation, hue, contrast, noise). jax.random and torch draw other
numbers for one seed.

Hue and saturation are linear maps in YIQ space (3 x 3 products), as in
the JAX package; the module keeps its own copy of the two matrices.
`resize` is `jax.image.resize(method='bilinear')`, whose antialias
(default on) widens the triangle kernel by the inverse scale on a
downscale: `F.interpolate(mode='bilinear', antialias=True,
align_corners=False)` computes the same separable weights (within
2.4e-7 at 80 -> 64, 96 -> 64 and 48 -> 32 and on an upscale,
tests/test_torch_image_ops.py).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "to_float_image", "to_uint8_image",
    "center_crop", "random_crop", "crop_image", "custom_crop",
    "resize", "random_flip_left_right",
    "random_brightness", "random_contrast", "random_saturation",
    "random_hue", "add_gaussian_noise",
    "apply_photometric_distortions", "apply_depth_distortions",
    "crop_resize_distort", "random_gamma",
    "apply_cheap_photometric_distortions",
    "draw_crop_offsets", "draw_photometric", "draw_depth",
    "draw_crop_resize_distort", "draw_cheap_photometric",
]

Draws = Dict[str, torch.Tensor]

_RGB_TO_YIQ = ((0.299, 0.587, 0.114),
               (0.596, -0.274, -0.322),
               (0.211, -0.523, 0.312))
_YIQ_TO_RGB = ((1.0, 0.956, 0.621),
               (1.0, -0.272, -0.647),
               (1.0, -1.106, 1.703))


def _matrix(rows, like: torch.Tensor) -> torch.Tensor:
  # float32 constants (the JAX package's numpy arrays), widened to the
  # image's dtype.
  return torch.tensor(rows, dtype=torch.float32).to(like.device, like.dtype)


def _check_batched(image: torch.Tensor) -> None:
  if image.ndim != 4:
    raise ValueError(f"Expected [B,H,W,C] image batch, got "
                     f"{tuple(image.shape)}")


def _per_image(values: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
  """[B] (or [B, 1, 1, 1]) draws as [B, 1, 1, 1] on the image's device."""
  return values.reshape(-1, 1, 1, 1).to(image.device, image.dtype)


def to_float_image(image: torch.Tensor) -> torch.Tensor:
  """uint8 [0, 255] -> float32 [0, 1]; a float image becomes float32."""
  if not torch.is_floating_point(image):
    return image.to(torch.float32) / 255.0
  return image.to(torch.float32)


def to_uint8_image(image: torch.Tensor) -> torch.Tensor:
  return torch.clamp(image * 255.0 + 0.5, 0, 255).to(torch.uint8)


def center_crop(image: torch.Tensor, target_height: int,
                target_width: int) -> torch.Tensor:
  _check_batched(image)
  _, h, w, _ = image.shape
  if target_height > h or target_width > w:
    raise ValueError(f"Crop {target_height}x{target_width} larger than "
                     f"image {h}x{w}.")
  top = (h - target_height) // 2
  left = (w - target_width) // 2
  return image[:, top:top + target_height, left:left + target_width, :]


def crop_image(image: torch.Tensor, top: int, left: int, height: int,
               width: int) -> torch.Tensor:
  _check_batched(image)
  return image[:, top:top + height, left:left + width, :]


def _crop_at(image: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
             height: int, width: int) -> torch.Tensor:
  """Per-image windows: image i cropped at (tops[i], lefts[i])."""
  device = image.device
  rows = tops.to(device).reshape(-1, 1) + torch.arange(height, device=device)
  cols = lefts.to(device).reshape(-1, 1) + torch.arange(width, device=device)
  batch = torch.arange(image.shape[0], device=device)
  return image[batch[:, None, None], rows[:, :, None], cols[:, None, :]]


def custom_crop(image: torch.Tensor, centers: torch.Tensor,
                target_height: int, target_width: int) -> torch.Tensor:
  """Per-image crop around (y, x) pixel centers, clamped so the window
  stays inside the image (the JAX package's documented intent; see its
  docstring for the reference's transposed-center behaviour)."""
  _check_batched(image)
  _, h, w, _ = image.shape
  centers = torch.as_tensor(centers).to(image.device, torch.float32)
  cy = torch.clamp(centers[:, 0], target_height // 2, h - target_height // 2)
  cx = torch.clamp(centers[:, 1], target_width // 2, w - target_width // 2)
  tops = torch.clamp(torch.round(cy - target_height / 2.0).long(), 0,
                     h - target_height)
  lefts = torch.clamp(torch.round(cx - target_width / 2.0).long(), 0,
                      w - target_width)
  return _crop_at(image, tops, lefts, target_height, target_width)


def random_crop(image: torch.Tensor, target_height: int, target_width: int,
                tops: torch.Tensor, lefts: torch.Tensor) -> torch.Tensor:
  """Per-image crop at the drawn offsets (`draw_crop_offsets`)."""
  _check_batched(image)
  return _crop_at(image, tops, lefts, target_height, target_width)


def resize(image: torch.Tensor, target_height: int, target_width: int,
           method: str = "bilinear") -> torch.Tensor:
  """`jax.image.resize(..., method='bilinear')`, antialiased on a
  downscale (see the module docstring)."""
  _check_batched(image)
  if method != "bilinear":
    raise ValueError(f"only method='bilinear' is ported, got {method!r}")
  if tuple(image.shape[1:3]) == (target_height, target_width):
    return image
  out = F.interpolate(image.permute(0, 3, 1, 2),
                      size=(target_height, target_width), mode="bilinear",
                      antialias=True, align_corners=False)
  return out.permute(0, 2, 3, 1)


def random_flip_left_right(image: torch.Tensor,
                           flip: torch.Tensor) -> torch.Tensor:
  """Mirrors image i where flip[i] is true."""
  _check_batched(image)
  flip = flip.reshape(-1, 1, 1, 1).to(image.device, torch.bool)
  return torch.where(flip, image.flip(2), image)


def random_brightness(image: torch.Tensor,
                      delta: torch.Tensor) -> torch.Tensor:
  _check_batched(image)
  return torch.clamp(image + _per_image(delta, image), 0.0, 1.0)


def random_contrast(image: torch.Tensor,
                    factor: torch.Tensor) -> torch.Tensor:
  _check_batched(image)
  factor = _per_image(factor, image)
  mean = image.mean(dim=(1, 2), keepdim=True)
  return torch.clamp((image - mean) * factor + mean, 0.0, 1.0)


def random_saturation(image: torch.Tensor,
                      factor: torch.Tensor) -> torch.Tensor:
  _check_batched(image)
  factor = _per_image(factor, image)
  luma = (image * _matrix(_RGB_TO_YIQ, image)[0]).sum(-1, keepdim=True)
  return torch.clamp(luma + (image - luma) * factor, 0.0, 1.0)


def random_hue(image: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
  """Rotation by theta[i] (radians) of the IQ plane of image i."""
  _check_batched(image)
  theta = theta.reshape(-1).to(image.device, image.dtype)
  cos, sin = torch.cos(theta), torch.sin(theta)
  zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
  rot = torch.stack([
      torch.stack([ones, zeros, zeros], -1),
      torch.stack([zeros, cos, -sin], -1),
      torch.stack([zeros, sin, cos], -1),
  ], dim=-2)  # [B, 3, 3]
  yiq = torch.einsum("bhwc,dc->bhwd", image, _matrix(_RGB_TO_YIQ, image))
  yiq = torch.einsum("bhwc,bdc->bhwd", yiq, rot)
  rgb = torch.einsum("bhwc,dc->bhwd", yiq, _matrix(_YIQ_TO_RGB, image))
  return torch.clamp(rgb, 0.0, 1.0)


def add_gaussian_noise(image: torch.Tensor, noise: torch.Tensor,
                       stddev: float = 0.025) -> torch.Tensor:
  """`noise` is a unit normal draw of the image's shape."""
  _check_batched(image)
  return torch.clamp(image + stddev * noise.to(image.device, image.dtype),
                     0.0, 1.0)


def apply_photometric_distortions(image: torch.Tensor, draws: Draws,
                                  random_noise_level: float = 0.0
                                  ) -> torch.Tensor:
  """Brightness, saturation, hue, contrast and (with a noise level)
  gaussian noise, from `draw_photometric`'s draws."""
  image = random_brightness(image, draws["brightness"])
  image = random_saturation(image, draws["saturation"])
  image = random_hue(image, draws["hue"])
  image = random_contrast(image, draws["contrast"])
  if random_noise_level:
    image = add_gaussian_noise(image, draws["noise"], random_noise_level)
  return image


def apply_depth_distortions(depth: torch.Tensor, scale: torch.Tensor,
                            noise: Optional[torch.Tensor] = None,
                            random_noise_level: float = 0.05
                            ) -> torch.Tensor:
  """Per-image multiplicative scale plus additive gaussian noise, floored
  at 0."""
  _check_batched(depth)
  depth = depth * _per_image(scale, depth)
  if random_noise_level:
    depth = depth + random_noise_level * noise.to(depth.device, depth.dtype)
  return torch.clamp(depth, min=0.0)


def crop_resize_distort(image: torch.Tensor,
                        crop_size: Tuple[int, int],
                        target_size: Tuple[int, int],
                        is_training: bool = True,
                        distort: bool = True,
                        draws: Optional[Draws] = None) -> torch.Tensor:
  """to float -> random crop (training; else center crop) -> resize ->
  photometric chain (training with `distort`). `draws` come from
  `draw_crop_resize_distort`; eval needs none."""
  image = to_float_image(image)
  if is_training:
    image = random_crop(image, *crop_size, draws["tops"], draws["lefts"])
  else:
    image = center_crop(image, *crop_size)
  if tuple(target_size) != tuple(crop_size):
    image = resize(image, *target_size)
  if is_training and distort:
    image = apply_photometric_distortions(image, draws)
  return image


def random_gamma(image: torch.Tensor,
                 log_gamma: torch.Tensor) -> torch.Tensor:
  _check_batched(image)
  return torch.clamp(image, 1e-6, 1.0) ** torch.exp(
      _per_image(log_gamma, image))


def apply_cheap_photometric_distortions(image: torch.Tensor,
                                        draws: Draws) -> torch.Tensor:
  """Gamma, then a small brightness shift (`draw_cheap_photometric`)."""
  image = random_gamma(image, draws["log_gamma"])
  return random_brightness(image, draws["brightness"])


# -- draws ---------------------------------------------------------------------


def _uniform(generator: torch.Generator, shape: Sequence[int], low: float,
             high: float) -> torch.Tensor:
  return low + (high - low) * torch.rand(tuple(shape), generator=generator)


def draw_crop_offsets(generator: torch.Generator, batch: int, height: int,
                      width: int, target_height: int, target_width: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(tops, lefts), each [B] uniform over the valid offsets."""
  tops = torch.randint(0, height - target_height + 1, (batch,),
                       generator=generator)
  lefts = torch.randint(0, width - target_width + 1, (batch,),
                        generator=generator)
  return tops, lefts


def draw_photometric(generator: torch.Generator, image_shape: Sequence[int],
                     random_brightness_delta: float = 0.125,
                     random_saturation_range: Tuple[float, float] = (0.5, 1.5),
                     random_hue_delta: float = 0.2,
                     random_contrast_range: Tuple[float, float] = (0.5, 1.5),
                     random_noise_level: float = 0.0) -> Draws:
  """The photometric chain's draws for a [B, H, W, C] batch: brightness
  deltas, saturation factors, hue angles, contrast factors ([B] each)
  and, with a noise level, a unit normal of the image's shape."""
  b = image_shape[0]
  draws = {
      "brightness": _uniform(generator, (b,), -random_brightness_delta,
                             random_brightness_delta),
      "saturation": _uniform(generator, (b,), *random_saturation_range),
      "hue": _uniform(generator, (b,), -random_hue_delta * math.pi,
                      random_hue_delta * math.pi),
      "contrast": _uniform(generator, (b,), *random_contrast_range),
  }
  if random_noise_level:
    draws["noise"] = torch.randn(tuple(image_shape), generator=generator)
  return draws


def draw_depth(generator: torch.Generator, depth_shape: Sequence[int],
               random_noise_level: float = 0.05,
               scale_range: Tuple[float, float] = (0.9, 1.1)) -> Draws:
  """`apply_depth_distortions`' draws: `scale` [B] and `noise`."""
  draws = {"scale": _uniform(generator, (depth_shape[0],), *scale_range)}
  if random_noise_level:
    draws["noise"] = torch.randn(tuple(depth_shape), generator=generator)
  return draws


def draw_crop_resize_distort(generator: torch.Generator,
                             image_shape: Sequence[int],
                             crop_size: Tuple[int, int],
                             target_size: Tuple[int, int],
                             is_training: bool = True,
                             distort: bool = True) -> Draws:
  """`crop_resize_distort`'s draws for a [B, H, W, C] batch: crop
  offsets, then the photometric chain's (on the resized shape)."""
  if not is_training:
    return {}
  b, h, w, c = image_shape
  tops, lefts = draw_crop_offsets(generator, b, h, w, *crop_size)
  draws = {"tops": tops, "lefts": lefts}
  if distort:
    draws.update(draw_photometric(generator, (b, *target_size, c)))
  return draws


def draw_cheap_photometric(generator: torch.Generator, batch: int,
                           max_log_gamma: float = 0.3,
                           max_brightness_delta: float = 0.05) -> Draws:
  return {"log_gamma": _uniform(generator, (batch,), -max_log_gamma,
                                max_log_gamma),
          "brightness": _uniform(generator, (batch,), -max_brightness_delta,
                                 max_brightness_delta)}
