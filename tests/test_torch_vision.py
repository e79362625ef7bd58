"""The port's vision layers against the JAX package's, on the CPU.

`layers/spatial_softmax.py` and `layers/vision.py`: the same numpy inputs
go through the flax module (flax init) and the port's, with the flax
parameters carried across by `bridge.state_dict_from_flax` and the batch
statistics by `bridge.mutable_state_from_flax`. Maps have H != W and
C > 1, so a softmax or a norm over the wrong axes fails.

Tolerances: f32 outputs and new batch statistics 1e-5 of max(1, max
|ref|); the initialisers' constants exactly, their random draws by
statistics over a large draw against flax's own initialisers (range
within the bound, mean within 4 standard errors, std within 2%).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers import spatial_softmax as jax_ssm
from tensor2robot_tpu.layers import vision as jax_vision
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.layers import spatial_softmax
from tensor2robot_tpu_torch.layers import vision
from tensor2robot_tpu_torch.models import abstract

torch.set_num_threads(1)

F32_TOL = 1e-5


def _err(got, want) -> float:
  got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   np.float64)
  want = np.asarray(want, np.float64)
  assert got.shape == want.shape, (got.shape, want.shape)
  return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _images(rng, batch=3, h=12, w=16, c=3):
  return rng.randint(0, 256, (batch, h, w, c)).astype(np.uint8)


def _jax_apply(module, images, cond=None, train=False, seed=0):
  args = (jnp.asarray(images),) if cond is None else (
      jnp.asarray(images), jnp.asarray(cond))
  variables = module.init(jax.random.PRNGKey(seed), *args, train=train)
  if train and "batch_stats" in variables:
    out, new = module.apply(variables, *args, train=True,
                            mutable=["batch_stats"])
    return variables, out, new["batch_stats"]
  return variables, module.apply(variables, *args, train=train), {}


def _port_apply(module, variables, images, cond=None, train=False,
                prefix=""):
  params = bridge.state_dict_from_flax(variables["params"])
  state = bridge.mutable_state_from_flax(variables.get("batch_stats", {}))
  assert set(params) == set(dict(module.named_parameters()))
  assert set(state) == set(dict(module.named_buffers()))
  kwargs = {"train": train}
  if cond is not None:
    kwargs["conditioning"] = torch.from_numpy(cond)
  return torch.func.functional_call(module, {**params, **state},
                                    (torch.from_numpy(images),), kwargs)


class TestSpatialSoftmax:

  @pytest.mark.parametrize("temperature", [None, 0.37])
  def test_function_on_5x7(self, temperature):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 7, 3).astype(np.float32) * 3  # NHWC, H != W
    t = None if temperature is None else jnp.float32(temperature)
    want = jax_ssm.spatial_softmax(jnp.asarray(x), t)
    got = spatial_softmax.spatial_softmax(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        None if temperature is None else torch.tensor(temperature))
    assert got.shape == (2, 6)
    assert _err(got, want) <= F32_TOL

  def test_injected_gumbel_draws(self):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jax_ssm.spatial_softmax(jnp.asarray(x), None, key)
    # The JAX package's draws for this key, handed to the port.
    uniform = jax.random.uniform(key, (2, 3, 35), minval=1e-10, maxval=1.0)
    got = spatial_softmax.spatial_softmax(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        uniform=torch.from_numpy(np.array(uniform)))
    assert _err(got, want) <= F32_TOL

  def test_x_runs_along_width(self):
    # One hot pixel at row 1 of 5, column 6 of 7: x = 1, y = -0.5.
    x = np.full((1, 1, 5, 7), -1e4, np.float32)
    x[0, 0, 1, 6] = 0.0
    got = spatial_softmax.spatial_softmax(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), [[1.0, -0.5]], atol=1e-6)

  def test_learned_temperature_module(self):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 7, 4).astype(np.float32)
    module = jax_ssm.SpatialSoftmax(learn_temperature=True,
                                    initial_temperature=0.5)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = spatial_softmax.SpatialSoftmax(learn_temperature=True,
                                          initial_temperature=0.5)
    init = port.initial_params(torch.Generator())
    assert init["log_temperature"].item() == np.float32(math.log(0.5))
    assert init["log_temperature"].item() == float(
        variables["params"]["log_temperature"])
    params = bridge.state_dict_from_flax(variables["params"])
    assert set(params) == {"log_temperature"}
    got = torch.func.functional_call(
        port, params, (torch.from_numpy(x).permute(0, 3, 1, 2),))
    assert _err(got, module.apply(variables, jnp.asarray(x))) <= F32_TOL

  def test_gumbel_module_draws_from_its_generator(self):
    x = torch.randn(2, 3, 5, 7, generator=torch.Generator().manual_seed(0))
    a = spatial_softmax.SpatialSoftmax(
        gumbel_sampling=True, generator=torch.Generator().manual_seed(5))
    b = spatial_softmax.SpatialSoftmax(
        gumbel_sampling=True, generator=torch.Generator().manual_seed(5))
    first, again = a(x, train=True), b(x, train=True)
    assert torch.equal(first, again)
    assert not torch.equal(first, a(x, train=True))
    assert torch.equal(a(x), spatial_softmax.spatial_softmax(x))


CASES = [("layer_norm", 0), ("layer_norm", 5), ("batch_norm", 0),
         ("batch_norm", 5), ("none", 0), ("none", 5)]


class TestBerkeleyNet:

  @pytest.mark.parametrize("normalizer,condition_size", CASES)
  @pytest.mark.parametrize("train", [False, True])
  def test_tower_matches(self, normalizer, condition_size, train):
    rng = np.random.RandomState(3)
    images = _images(rng)
    cond = (rng.randn(3, condition_size).astype(np.float32)
            if condition_size else None)
    module = jax_vision.BerkeleyNet(filters=(4, 3), kernel_sizes=(5, 3),
                                    strides=(2, 1), normalizer=normalizer)
    variables, want, want_stats = _jax_apply(module, images, cond, train)
    port = vision.BerkeleyNet(3, filters=(4, 3), kernel_sizes=(5, 3),
                              strides=(2, 1), normalizer=normalizer,
                              condition_size=condition_size)
    got, stats = _port_apply(port, variables, images, cond, train)
    assert got.shape == (3, 6)
    assert _err(got, want) <= F32_TOL
    want_stats = bridge.mutable_state_from_flax(want_stats)
    assert set(stats) == set(want_stats)
    for key in stats:
      assert _err(stats[key], want_stats[key]) <= F32_TOL, key

  @pytest.mark.parametrize("flatten", [True, False])
  def test_feature_map_path(self, flatten):
    rng = np.random.RandomState(4)
    images = _images(rng, h=11, w=8)
    module = jax_vision.BerkeleyNet(filters=(4, 3), kernel_sizes=(5, 3),
                                    strides=(2, 1), use_spatial_softmax=False,
                                    flatten=flatten)
    variables, want, _ = _jax_apply(module, images)
    port = vision.BerkeleyNet(3, filters=(4, 3), kernel_sizes=(5, 3),
                              strides=(2, 1), use_spatial_softmax=False,
                              flatten=flatten)
    got, _ = _port_apply(port, variables, images)
    assert tuple(got.shape) == want.shape  # NHWC order, as in JAX
    assert _err(got, want) <= F32_TOL

  def test_layer_norm_is_per_pixel_over_channels(self):
    port = vision.BerkeleyNet(3, filters=(4,), kernel_sizes=(3,),
                              strides=(1,), use_spatial_softmax=False,
                              flatten=False)
    params = {k: torch.randn(v.shape, generator=torch.Generator()
                             .manual_seed(0)) for k, v in
              port.named_parameters()}
    params["norm_0.weight"] = torch.ones(4)
    params["norm_0.bias"] = torch.zeros(4)
    images = torch.from_numpy(_images(np.random.RandomState(5), h=5, w=7))
    out, _ = torch.func.functional_call(port, params, (images,))
    # Before the relu every pixel's channels had mean 0 and variance 1.
    conv = vision.flax_layers.conv2d(images.permute(0, 3, 1, 2) / 255.0,
                                     params["conv_0.weight"])
    normed = (conv - conv.mean(1, keepdim=True)) / torch.sqrt(
        conv.var(1, unbiased=False, keepdim=True) + 1e-12)
    np.testing.assert_allclose(out.numpy(),
                               torch.relu(normed).permute(0, 2, 3, 1).numpy(),
                               atol=2e-5)

  def test_pipelined_tower_waits_for_item_14(self):
    """The ported `PipelinedBerkeleyTower` (the raise this test once
    pinned is gone): its sequential schedule against the JAX tower's on
    the same raveled `pp_stages`, without and with FiLM conditioning
    riding the flat buffer, H != W and strides 2 and 1."""
    rng = np.random.RandomState(7)
    images = _images(rng, h=12, w=16)
    for condition_size in (0, 4):
      cond = (rng.randn(3, condition_size).astype(np.float32)
              if condition_size else None)
      kw = dict(filters=(4, 5, 3), kernel_sizes=(5, 3, 3),
                strides=(2, 1, 2), condition_size=condition_size)
      variables, want, _ = _jax_apply(
          jax_vision.PipelinedBerkeleyTower(**kw), images, cond)
      port = vision.PipelinedBerkeleyTower((12, 16, 3), **kw)
      got, _ = _port_apply(port, variables, images, cond)
      assert tuple(got.shape) == want.shape == (3, 3, 4, 3)
      assert _err(got, want) <= F32_TOL, condition_size

  def test_high_res_variant(self):
    rng = np.random.RandomState(6)
    images = _images(rng, h=10, w=14)
    cond = rng.randn(3, 4).astype(np.float32)
    module = jax_vision.HighResBerkeleyNet(filters=(4, 3), high_res_filters=5)
    variables, want, _ = _jax_apply(module, images, cond)
    port = vision.HighResBerkeleyNet(3, filters=(4, 3), high_res_filters=5,
                                     condition_size=4)
    got, _ = _port_apply(port, variables, images, cond)
    assert got.shape == (3, 6 + 10)
    assert _err(got, want) <= F32_TOL


class TestPoseHead:

  @pytest.mark.parametrize("bias_transform_size", [0, 6])
  @pytest.mark.parametrize("normalizer", ["layer_norm", "none"])
  def test_head_matches(self, bias_transform_size, normalizer):
    rng = np.random.RandomState(7)
    x = rng.randn(4, 10).astype(np.float32)
    module = jax_vision.PoseHead(output_size=3, hidden_sizes=(8, 5),
                                 bias_transform_size=bias_transform_size,
                                 normalizer=normalizer)
    variables = module.init(jax.random.PRNGKey(1), jnp.asarray(x))
    port = vision.PoseHead(10, output_size=3, hidden_sizes=(8, 5),
                           bias_transform_size=bias_transform_size,
                           normalizer=normalizer)
    params = bridge.state_dict_from_flax(variables["params"])
    assert set(params) == set(dict(port.named_parameters()))
    if bias_transform_size:
      assert params["bias_transform"].shape == (bias_transform_size,)
      np.testing.assert_array_equal(
          params["bias_transform"].numpy(),
          np.asarray(variables["params"]["bias_transform"]))
    got = torch.func.functional_call(port, params, (torch.from_numpy(x),))
    assert _err(got, module.apply(variables, jnp.asarray(x))) <= F32_TOL


class _LayerModel(abstract.T2RModel):
  """A model around one layer tree, for `T2RModel.init_params`."""

  def __init__(self, layer):
    super().__init__()
    self._layer = layer

  def create_module(self):
    return self._layer

  def get_feature_specification(self, mode):
    raise NotImplementedError

  get_label_specification = get_feature_specification

  def model_train_fn(self, features, labels, inference_outputs, mode):
    raise NotImplementedError


def _init(layer):
  """A layer tree's fresh parameters, as `T2RModel.init_params` draws
  them."""
  return _LayerModel(layer).init_params(torch.Generator().manual_seed(0))


class TestInitialisers:

  def test_constants(self):
    tower = vision.BerkeleyNet(3, filters=(4, 3), normalizer="none")
    params = _init(tower)
    for i in range(2):
      assert torch.equal(params[f"conv_{i}.bias"],
                         torch.full((4, 3)[i:i + 1], 0.01))
    normed = _init(vision.BerkeleyNet(3, filters=(4, 3)))
    assert "conv_0.bias" not in normed
    assert torch.equal(normed["norm_0.weight"], torch.ones(4))
    assert torch.equal(normed["norm_0.bias"], torch.zeros(4))
    head = _init(vision.PoseHead(10, output_size=3, hidden_sizes=(8,),
                                 bias_transform_size=6))
    assert torch.equal(head["bias_transform"], torch.full((6,), 0.01))
    assert torch.equal(head["pose.bias"], torch.full((3,), 0.01))
    assert "fc_0.bias" not in head
    plain_head = _init(vision.PoseHead(10, hidden_sizes=(8,),
                                       normalizer="none"))
    assert torch.equal(plain_head["fc_0.bias"], torch.full((8,), 0.01))
    high = _init(vision.HighResBerkeleyNet(3, filters=(4,), condition_size=2))
    assert torch.equal(high["high_res_conv.bias"], torch.zeros(16))
    assert torch.equal(high["main.film_0.film_proj.bias"], torch.zeros(8))

  @pytest.mark.parametrize("which", ["conv", "high_res_conv", "fc"])
  def test_random_draws_match_flax_statistics(self, which):
    if which == "fc":
      port = vision.PoseHead(400, output_size=300, hidden_sizes=())
      got = _init(port)["pose.weight"].numpy()
      want = jax_vision._FC_KERNEL_INIT(jax.random.PRNGKey(0), (400, 300))
    else:
      kernel_init = (vision.xavier_uniform_ if which == "conv"
                     else vision.truncated_normal_(0.1))
      flax_init = (jax_vision._CONV_KERNEL_INIT if which == "conv"
                   else jax_vision._HIGH_RES_CONV_KERNEL_INIT)
      got = _init(vision.BerkeleyNet(
          48, filters=(64,), kernel_sizes=(7,), strides=(1,),
          conv_kernel_init=kernel_init))["conv_0.weight"].numpy()
      want = flax_init(jax.random.PRNGKey(0), (7, 7, 48, 64))
    want = np.asarray(want)
    assert got.size == want.size > 100_000
    bound = float(np.abs(want).max())
    assert np.abs(got).max() <= bound * 1.001
    assert np.abs(got).max() >= bound * 0.99
    assert abs(got.mean() - want.mean()) <= 4 * want.std() / math.sqrt(
        got.size)
    assert abs(got.std() / want.std() - 1.0) <= 0.02


class TestBridgeNames:

  def test_berkeley_names_round_trip(self):
    rng = np.random.RandomState(8)
    images = _images(rng)
    cond = rng.randn(3, 2).astype(np.float32)
    module = jax_vision.BerkeleyNet(filters=(4, 3), normalizer="batch_norm")
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(images),
                            jnp.asarray(cond))
    params = bridge.state_dict_from_flax(variables["params"])
    port = vision.BerkeleyNet(3, filters=(4, 3), normalizer="batch_norm",
                              condition_size=2)
    expected = {k: tuple(v.shape) for k, v in port.named_parameters()}
    assert {k: tuple(v.shape) for k, v in params.items()} == expected
    assert sorted(expected) == sorted(
        [f"conv_{i}.weight" for i in range(2)]
        + [f"norm_{i}.bias" for i in range(2)]
        + [f"film_{i}.film_proj.{p}" for i in range(2)
           for p in ("weight", "bias")])
    # OIHW from HWIO, element for element.
    np.testing.assert_array_equal(
        params["conv_1.weight"].numpy(),
        np.asarray(variables["params"]["conv_1"]["kernel"]).transpose(
            3, 2, 0, 1))
    stats = bridge.mutable_state_from_flax(variables["batch_stats"])
    assert set(stats) == set(dict(port.named_buffers()))

  def test_pose_head_names_round_trip(self):
    module = jax_vision.PoseHead(output_size=2, hidden_sizes=(8,),
                                 bias_transform_size=4)
    variables = module.init(jax.random.PRNGKey(0), jnp.ones((2, 6)))
    params = bridge.state_dict_from_flax(variables["params"])
    port = vision.PoseHead(6, output_size=2, hidden_sizes=(8,),
                           bias_transform_size=4)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in port.named_parameters()}
    assert sorted(params) == ["bias_transform", "fc_0.weight",
                              "fc_norm_0.bias", "fc_norm_0.weight",
                              "pose.bias", "pose.weight"]
