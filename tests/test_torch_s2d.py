"""The space-to-depth stem of Grasping44 in the port, on the CPU.

* `stem_kernel_to_s2d` on OIHW against the JAX package's on HWIO, through
  the bridge's kernel mapping: exact (a permutation of the same numbers).
* The NCHW fold against the JAX package's NHWC fold: exact.
* The padding: flax 'SAME' pads a 6x6 stride-2 conv over an even H by
  (2, 2), and the 3x3 'SAME' conv over the folded image by (1, 1); the
  two convs with the mapped kernel agree in float64 to 1e-12 relative
  (each output sums the same 108 products), at square and non-square
  sizes.
* The port's s2d critic (Grasping44 at the tests' width, f32, batch 2)
  against the plain stem with the mapped kernel, and against the JAX
  package's s2d forward on bridged weights (`conv1_1_s2d` HWIO [3, 3,
  12, F] -> OIHW): eval mode 1e-5 relative; train mode as
  `test_torch_qtopt_models.py` holds the plain stem (q 1e-5, the logits
  and running means, which cancel, 2e-5, running variances 1e-6).
* One s2d train step against the JAX s2d step on bridged weights, as
  `test_torch_qtopt_train.py` holds the plain step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu.research.qtopt import models as jax_models
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.parallel import train_step
from tensor2robot_tpu_torch.research.qtopt import flagship
from tensor2robot_tpu_torch.research.qtopt import models
from tests import test_torch_qtopt_models as qm
from tests import test_torch_qtopt_train as qt

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

EXACT_F64_RTOL = 1e-12


class _JaxS2DCritic(jax_models.QTOptModel):

  def create_module(self):
    return jax_models.Grasping44(
        num_convs=qm.NUM_CONVS, filters=qm.FILTERS,
        grasp_param_names=qm.BLOCKS, space_to_depth=True)


class _S2DCritic(models.QTOptModel):

  def __init__(self, space_to_depth=True, **kwargs):
    super().__init__(**kwargs)
    self._s2d = space_to_depth

  def create_module(self):
    return models.Grasping44(
        image_size=qm.SIZE, image_channels=3, grasp_param_size=5,
        num_convs=qm.NUM_CONVS, filters=qm.FILTERS,
        grasp_param_names=qm.BLOCKS, space_to_depth=self._s2d)


def _kwargs():
  return dict(image_size=qm.SIZE, action_size=5, network="grasping44",
              grasp_param_names=qm.BLOCKS)


@functools.lru_cache(maxsize=None)
def _setup():
  jax_model = _JaxS2DCritic(device_type="cpu", **_kwargs())
  model = _S2DCritic(**_kwargs())
  features = qm._features(model)
  return (jax_model, model) + qm._states(jax_model, features) + (features,)


def test_kernel_map_matches_jax():
  kernel = np.random.RandomState(0).randn(6, 6, 3, 8).astype(np.float32)
  want = bridge.state_dict_from_flax(
      {"k": {"kernel": np.asarray(jax_models.stem_kernel_to_s2d(
          jnp.asarray(kernel)))}})["k.weight"]
  got = models.stem_kernel_to_s2d(
      bridge.state_dict_from_flax({"k": {"kernel": kernel}})["k.weight"])
  assert got.shape == (8, 12, 3, 3)
  assert torch.equal(got, want)
  with pytest.raises(ValueError, match="6, 6"):
    models.stem_kernel_to_s2d(torch.zeros(8, 3, 5, 5))


def test_fold_matches_the_jax_nhwc_fold():
  image = np.random.RandomState(1).randn(2, 6, 10, 3).astype(np.float32)
  b, h, w, c = image.shape
  want = image.reshape(b, h // 2, 2, w // 2, 2, c).transpose(
      0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
  got = models.space_to_depth(torch.from_numpy(image).permute(0, 3, 1, 2))
  assert torch.equal(got.permute(0, 2, 3, 1), torch.from_numpy(want))
  with pytest.raises(ValueError, match="even"):
    models.space_to_depth(torch.zeros(1, 3, 6, 7))


@pytest.mark.parametrize("height,width", [(16, 16), (24, 10), (472, 472)])
def test_s2d_conv_equals_the_stride_2_stem(height, width):
  rs = np.random.RandomState(height + width)
  x = torch.from_numpy(rs.randn(2, 3, height, width))
  weight = torch.from_numpy(rs.randn(8, 3, 6, 6))
  bias = torch.from_numpy(rs.randn(8))
  assert flax_layers.same_padding(height, 6, 2) == (2, 2)
  assert flax_layers.same_padding(height // 2, 3, 1) == (1, 1)
  want = flax_layers.conv2d(x, weight, bias, stride=2)
  got = flax_layers.conv2d(models.space_to_depth(x),
                           models.stem_kernel_to_s2d(weight), bias)
  assert got.shape == want.shape == (2, 8, height // 2, width // 2)
  err = float((got - want).abs().max() / want.abs().max())
  assert err <= EXACT_F64_RTOL, err


@pytest.mark.parametrize("train", [False, True])
def test_s2d_critic_equals_the_plain_stem(train):
  _, model, _, state, features = _setup()
  plain = _S2DCritic(space_to_depth=False, **_kwargs())
  params = {k: v for k, v in state.params.items()
            if not k.startswith("conv1_1_s2d.")}
  params["conv1_1.bias"] = state.params["conv1_1_s2d.bias"]
  # The plain stem's kernel, whose s2d image is the s2d critic's.
  s2d_weight = state.params["conv1_1_s2d.weight"]
  weight = s2d_weight.reshape(qm.FILTERS, 2, 2, 3, 3, 3).permute(
      0, 3, 4, 1, 5, 2).reshape(qm.FILTERS, 3, 6, 6)
  assert torch.equal(models.stem_kernel_to_s2d(weight), s2d_weight)
  params["conv1_1.weight"] = weight
  batch = {k: torch.from_numpy(np.asarray(v)) for k, v in features.items()}
  batch, _ = model.preprocessor.preprocess(batch, {}, "train")
  with torch.no_grad():
    got, got_stats = model.inference_network_fn(
        state.params, state.mutable_state, batch, "train", train=train)
    want, want_stats = plain.inference_network_fn(
        params, state.mutable_state, batch, "train", train=train)
  for key in ("q_predicted", "logits"):
    tol = qm.F32_CANCELLING_RTOL if train and key == "logits" \
        else qm.F32_RTOL
    assert qm._rel(got[key], want[key]) <= tol, key
  assert got_stats.keys() == want_stats.keys()


@pytest.mark.parametrize("train", [False, True])
def test_s2d_critic_matches_jax(train):
  setup = _setup()
  assert setup[3].params["conv1_1_s2d.weight"].shape == (qm.FILTERS, 12, 3,
                                                         3)
  out, new, port_out, port_new = qm._forward_both(*setup, train)
  for key in ("q_predicted", "logits"):
    tol = qm.F32_CANCELLING_RTOL if train and key == "logits" \
        else qm.F32_RTOL
    assert qm._rel(port_out[key], out[key]) <= tol, key
  if train:
    qm._assert_stats_close(new, port_new)
  else:
    assert port_new == {}


def test_s2d_train_step_matches_jax():
  jax_model, model, jax_state, state, _ = _setup()
  features, labels = qt._batch(model)
  stepped, jax_metrics = jax_train_step.make_train_step(
      jax_model, donate=False)(jax_state, features, labels)
  new_state, metrics = train_step.make_train_step(model)(
      state, qt._torch(features), qt._torch(labels))
  for key in metrics:
    assert qt._rel(float(metrics[key]), float(jax_metrics[key])) \
        <= qt.LOSS_RTOL, key
  qt._assert_close(new_state.params, qt._state_dict(stepped.params),
                   qt.PARAM_ATOL)
  qt._assert_close(new_state.ema_params, qt._state_dict(stepped.ema_params),
                   qt.PARAM_ATOL)


def test_flagship_passes_remat_and_s2d_on():
  model = flagship.make_flagship_model(remat=True, space_to_depth=True)
  assert model.remat
  assert model.module.space_to_depth
  assert model.module.conv1_1_s2d.weight.shape == (64, 12, 3, 3)
  small = flagship.make_flagship_model("cpu", space_to_depth=True)
  assert small.network == "small" and not small.remat
