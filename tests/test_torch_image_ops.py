"""The port's image ops against the JAX package's, on the CPU.

`preprocessors/image_ops.py`: every op on the same numpy batch, the JAX
op drawing from its key and the port's op handed those same draws (the
JAX package's `jax.random` calls, repeated here with its key splits);
`resize` against `jax.image.resize(method='bilinear')` (antialiased) at
80 -> 64, 96 -> 64, 48 -> 32 and an upscale 32 -> 48; `crop_resize_distort`
in both modes. The port's own draw functions: shapes, ranges, and the
same numbers for one seed.

Tolerance: 1e-6 absolute on [0, 1] images (elementwise float32 work; the
resize sums its taps in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.preprocessors import image_ops as jax_ops
from tensor2robot_tpu_torch.preprocessors import image_ops

torch.set_num_threads(1)

TOL = 1e-6


def _image(seed=0, b=3, h=12, w=10, c=3):
  return np.random.RandomState(seed).rand(b, h, w, c).astype(np.float32)


def _t(x):
  return torch.from_numpy(np.array(x))


def _err(got, want) -> float:
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  assert got.shape == np.shape(want), (got.shape, np.shape(want))
  return float(np.abs(np.float64(got) - np.float64(want)).max())


def _uniform(key, b, low, high):
  return jax.random.uniform(key, (b, 1, 1, 1), minval=low, maxval=high)


def _photometric_draws(key, shape, noise_level=0.0):
  """The JAX package's draws in `apply_photometric_distortions`."""
  keys = jax.random.split(key, 5)
  b = shape[0]
  draws = {"brightness": _uniform(keys[0], b, -0.125, 0.125),
           "saturation": _uniform(keys[1], b, 0.5, 1.5),
           "hue": jax.random.uniform(keys[2], (b,), minval=-0.2 * jnp.pi,
                                     maxval=0.2 * jnp.pi),
           "contrast": _uniform(keys[3], b, 0.5, 1.5)}
  if noise_level:
    draws["noise"] = jax.random.normal(keys[4], shape)
  return {k: _t(v) for k, v in draws.items()}


def _crop_draws(key, b, h, w, th, tw):
  key_top, key_left = jax.random.split(key)
  return (_t(jax.random.randint(key_top, (b,), 0, h - th + 1)),
          _t(jax.random.randint(key_left, (b,), 0, w - tw + 1)))


def test_float_and_uint8_conversions():
  raw = np.random.RandomState(1).randint(0, 256, (2, 4, 5, 3)).astype(
      np.uint8)
  got = image_ops.to_float_image(_t(raw))
  assert got.dtype == torch.float32
  assert _err(got, jax_ops.to_float_image(jnp.asarray(raw))) <= TOL
  back = image_ops.to_uint8_image(got)
  assert np.array_equal(back.numpy(), np.asarray(
      jax_ops.to_uint8_image(jax_ops.to_float_image(jnp.asarray(raw)))))


def test_static_crops():
  x = _image()
  assert np.array_equal(image_ops.center_crop(_t(x), 7, 5).numpy(),
                        np.asarray(jax_ops.center_crop(jnp.asarray(x), 7, 5)))
  assert np.array_equal(image_ops.crop_image(_t(x), 2, 3, 6, 4).numpy(),
                        np.asarray(jax_ops.crop_image(jnp.asarray(x), 2, 3,
                                                      6, 4)))
  with pytest.raises(ValueError, match="larger than"):
    image_ops.center_crop(_t(x), 13, 5)


def test_custom_crop_clamps_centers():
  x = _image(b=4)
  centers = np.array([[0, 0], [11, 9], [5.5, 4.5], [6.5, 2]], np.float32)
  want = jax_ops.custom_crop(jnp.asarray(x), jnp.asarray(centers), 6, 4)
  got = image_ops.custom_crop(_t(x), _t(centers), 6, 4)
  assert np.array_equal(got.numpy(), np.asarray(want))


def test_random_crop_with_injected_offsets():
  x = _image(b=5)
  key = jax.random.PRNGKey(3)
  want = jax_ops.random_crop(key, jnp.asarray(x), 7, 6)
  tops, lefts = _crop_draws(key, 5, 12, 10, 7, 6)
  got = image_ops.random_crop(_t(x), 7, 6, tops, lefts)
  assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size,target", [(80, 64), (96, 64), (48, 32),
                                         (32, 48)])
def test_resize_is_jax_bilinear_antialiased(size, target):
  x = _image(seed=size, b=2, h=size, w=size)
  want = jax_ops.resize(jnp.asarray(x), target, target)
  got = image_ops.resize(_t(x), target, target)
  assert got.shape == (2, target, target, 3)
  assert _err(got, want) <= TOL


def test_resize_keeps_the_same_size_and_knows_one_method():
  x = _t(_image())
  assert image_ops.resize(x, 12, 10) is x
  with pytest.raises(ValueError, match="bilinear"):
    image_ops.resize(x, 6, 5, method="bicubic")


def test_flip_with_injected_draws():
  x = _image(b=6)
  key = jax.random.PRNGKey(4)
  want = jax_ops.random_flip_left_right(key, jnp.asarray(x))
  flip = jax.random.bernoulli(key, 0.5, (6, 1, 1, 1))
  assert 0 < int(flip.sum()) < 6
  got = image_ops.random_flip_left_right(_t(x), _t(flip))
  assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("op,low,high", [("random_brightness", -0.125, 0.125),
                                         ("random_contrast", 0.5, 1.5),
                                         ("random_saturation", 0.5, 1.5)])
def test_per_image_photometric_ops(op, low, high):
  x = _image(b=4)
  key = jax.random.PRNGKey(5)
  want = getattr(jax_ops, op)(key, jnp.asarray(x))
  draw = _uniform(key, 4, low, high)
  got = getattr(image_ops, op)(_t(x), _t(draw))
  assert _err(got, want) <= TOL
  assert _err(got, x) > 1e-3  # the op did something


def test_hue_rotation():
  x = _image(b=4)
  key = jax.random.PRNGKey(6)
  want = jax_ops.random_hue(key, jnp.asarray(x))
  theta = jax.random.uniform(key, (4,), minval=-0.2 * jnp.pi,
                             maxval=0.2 * jnp.pi)
  got = image_ops.random_hue(_t(x), _t(theta))
  assert _err(got, want) <= TOL
  assert _err(got, x) > 1e-3


def test_gaussian_noise():
  x = _image()
  key = jax.random.PRNGKey(7)
  want = jax_ops.add_gaussian_noise(key, jnp.asarray(x), 0.05)
  got = image_ops.add_gaussian_noise(
      _t(x), _t(jax.random.normal(key, x.shape)), 0.05)
  assert _err(got, want) <= TOL


@pytest.mark.parametrize("noise", [0.0, 0.03])
def test_photometric_chain(noise):
  x = _image(b=4)
  key = jax.random.PRNGKey(8)
  want = jax_ops.apply_photometric_distortions(
      key, jnp.asarray(x), random_noise_level=noise)
  got = image_ops.apply_photometric_distortions(
      _t(x), _photometric_draws(key, x.shape, noise), noise)
  assert _err(got, want) <= TOL


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_depth_distortions(noise):
  depth = _image(c=1) * 3.0 - 0.5
  key = jax.random.PRNGKey(9)
  want = jax_ops.apply_depth_distortions(key, jnp.asarray(depth),
                                         random_noise_level=noise)
  key_scale, key_noise = jax.random.split(key)
  scale = _uniform(key_scale, 3, 0.9, 1.1)
  draw = jax.random.normal(key_noise, depth.shape) if noise else None
  got = image_ops.apply_depth_distortions(
      _t(depth), _t(scale), None if draw is None else _t(draw),
      random_noise_level=noise)
  assert _err(got, want) <= TOL
  assert float(got.min()) == 0.0  # floored


def test_cheap_photometric_chain():
  x = _image()
  key = jax.random.PRNGKey(10)
  want = jax_ops.apply_cheap_photometric_distortions(key, jnp.asarray(x))
  key_gamma, key_bright = jax.random.split(key)
  draws = {"log_gamma": _t(_uniform(key_gamma, 3, -0.3, 0.3)),
           "brightness": _t(_uniform(key_bright, 3, -0.05, 0.05))}
  got = image_ops.apply_cheap_photometric_distortions(_t(x), draws)
  assert _err(got, want) <= TOL


@pytest.mark.parametrize("is_training", [True, False])
def test_crop_resize_distort(is_training):
  raw = np.random.RandomState(11).randint(0, 256, (3, 24, 26, 3)).astype(
      np.uint8)
  key = jax.random.PRNGKey(12)
  want = jax_ops.crop_resize_distort(key, jnp.asarray(raw), (20, 20),
                                     (16, 16), is_training=is_training)
  key_crop, key_dist = jax.random.split(key)
  draws = {}
  if is_training:
    draws["tops"], draws["lefts"] = _crop_draws(key_crop, 3, 24, 26, 20, 20)
    draws.update(_photometric_draws(key_dist, (3, 16, 16, 3)))
  got = image_ops.crop_resize_distort(_t(raw), (20, 20), (16, 16),
                                      is_training=is_training, draws=draws)
  assert got.shape == (3, 16, 16, 3)
  assert _err(got, want) <= TOL


def test_port_draws_follow_the_split_order_and_ranges():
  shape = (5, 40, 44, 3)
  a = image_ops.draw_crop_resize_distort(torch.Generator().manual_seed(3),
                                         shape, (32, 32), (16, 16))
  b = image_ops.draw_crop_resize_distort(torch.Generator().manual_seed(3),
                                         shape, (32, 32), (16, 16))
  assert list(a) == ["tops", "lefts", "brightness", "saturation", "hue",
                     "contrast"]
  for key in a:
    assert torch.equal(a[key], b[key]) and a[key].shape == (5,)
  assert 0 <= int(a["tops"].min()) and int(a["tops"].max()) <= 8
  assert 0 <= int(a["lefts"].min()) and int(a["lefts"].max()) <= 12
  assert float(a["brightness"].abs().max()) <= 0.125
  assert float(a["hue"].abs().max()) <= 0.2 * np.pi
  for key in ("saturation", "contrast"):
    assert 0.5 <= float(a[key].min()) and float(a[key].max()) <= 1.5
  assert image_ops.draw_crop_resize_distort(
      torch.Generator(), shape, (32, 32), (16, 16), is_training=False) == {}
  noisy = image_ops.draw_photometric(torch.Generator().manual_seed(0),
                                     (2, 4, 4, 3), random_noise_level=0.1)
  assert noisy["noise"].shape == (2, 4, 4, 3)
  depth = image_ops.draw_depth(torch.Generator().manual_seed(0), (2, 4, 4, 1))
  assert depth["scale"].shape == (2,) and depth["noise"].shape == (2, 4, 4, 1)
  cheap = image_ops.draw_cheap_photometric(torch.Generator().manual_seed(0),
                                           4)
  assert float(cheap["log_gamma"].abs().max()) <= 0.3
