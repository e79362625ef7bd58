"""Grasp2Vec visualization: keypoint heatmap overlays.

Counterpart of `tensor2robot_tpu.research.grasp2vec.visualization`, the
port's own copy (numpy and PIL): a (low-res) localization heatmap, the
goal embedding against the scene's spatial features, is coloured blue to
red, resized to the scene image and blended over it; the overlays are
written as PNG files. The same heatmap and image give the same bytes as
the JAX package's writer.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["render_heatmap_overlay", "save_heatmap_summaries"]


def _colormap(values: np.ndarray) -> np.ndarray:
  """[H, W] in [0,1] -> [H, W, 3] uint8 blue->red colormap."""
  v = np.clip(values, 0.0, 1.0)
  r = (255 * v).astype(np.uint8)
  g = (255 * (1.0 - np.abs(v - 0.5) * 2)).astype(np.uint8)
  b = (255 * (1.0 - v)).astype(np.uint8)
  return np.stack([r, g, b], axis=-1)


def render_heatmap_overlay(image: np.ndarray, heatmap: np.ndarray,
                           alpha: float = 0.5) -> np.ndarray:
  """Overlays a (low-res) heatmap on an image; returns [H, W, 3] uint8."""
  from PIL import Image

  image = np.asarray(image)
  if image.dtype != np.uint8:
    image = np.clip(image * 255.0, 0, 255).astype(np.uint8)
  if image.shape[-1] == 1:
    image = np.repeat(image, 3, axis=-1)
  heatmap = np.asarray(heatmap, np.float32)
  lo, hi = heatmap.min(), heatmap.max()
  norm = (heatmap - lo) / (hi - lo + 1e-8)
  colored = _colormap(norm)
  resized = np.asarray(Image.fromarray(colored).resize(
      (image.shape[1], image.shape[0])))
  blended = ((1 - alpha) * image + alpha * resized).astype(np.uint8)
  return blended


def save_heatmap_summaries(output_dir: str,
                           step: int,
                           images: np.ndarray,
                           heatmaps: np.ndarray,
                           max_images: int = 4) -> list:
  """Writes overlay PNGs `heatmap_<step>_<i>.png`; returns paths."""
  from PIL import Image

  os.makedirs(output_dir, exist_ok=True)
  paths = []
  for i in range(min(len(images), max_images)):
    overlay = render_heatmap_overlay(images[i], heatmaps[i])
    path = os.path.join(output_dir, f"heatmap_{step}_{i}.png")
    Image.fromarray(overlay).save(path)
    paths.append(path)
  return paths
