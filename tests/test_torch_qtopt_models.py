"""The QT-Opt critic's networks against the JAX package's, on the CPU.

The same numpy batch goes through the JAX model (flax init; the model's
own `inference_network_fn`, bfloat16 cast included) and the port's, with
the JAX variables (params and batch_stats) carried across by
`bridge.train_state_from_jax`: `GraspingCNN` at 32x32, and `Grasping44`
at 256x256 with filters 16 and num_convs (1, 1, 3), batch 2.

Tolerances:

* f32: q 1e-5 relative (max |err| / max |ref|) in train and eval mode,
  logits 1e-5 in eval mode, the new running variances 1e-6 relative per
  leaf. Two quantities cancel and are held to 2e-5, twice the distance
  of either package from a float64 run of the same math
  (`tests/torch_qtopt_floors.py`, seeds 0-3):
  - the train-mode logits: both sides sum in f32 in different orders,
    and batch norm over two rows divides those differences by small
    batch deviations (JAX 0.7e-6 to 8.2e-6 from float64, the port 1.6e-6
    to 9.8e-6, up to 1.45e-5 from each other);
  - the new running means: 0.0003 x a batch mean of activations of both
    signs, which cancel (JAX 7.6e-6 to 8.7e-6, the port 4.1e-6 to
    7.0e-6, up to 8.6e-6 from each other).
* bf16 policy, eval mode (running statistics): logits 1e-2 by relative
  2-norm, a bf16 rounding point that flips by one step.
* bf16 policy, train mode: normalising by the batch statistics divides
  each bf16-rounded activation's error (2^-9 of |x|) by the batch
  deviation, so where a run rounds moves the logits by several percent:
  the JAX package's own model lies 3.6-8.4% (relative 2-norm) from
  itself between eager and jitted execution, and 0.7-13.8% from its f32
  logits (`tests/torch_qtopt_floors.py`, seeds 0-3, batches 2 and 8).
  The port's bf16 logits are held to the JAX package's eager ones by
  that yardstick: no farther than the jitted JAX run of the same
  function on the same batch (they read 1.2-3.6%).

The TF 'SAME' padding of the convs and max-pools is held against
`jax.lax` at odd and even sizes, and the 0.01 truncated-normal init
against its bounds and std.
"""

import functools

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu.research.qtopt import models as jax_models
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.layers import flax_layers
from tensor2robot_tpu_torch.research.qtopt import flagship
from tensor2robot_tpu_torch.research.qtopt import models

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

F32_RTOL = 1e-5
F32_CANCELLING_RTOL = 2e-5
STATS_VAR_RTOL = 1e-6
BF16_EVAL_REL_NORM = 1e-2
BLOCKS = {"world_vector": (0, 3), "vertical_rotation": (3, 2)}
SIZE, FILTERS, NUM_CONVS = 256, 16, (1, 1, 3)


class _JaxCritic(jax_models.QTOptModel):
  """Grasping44 at the test width (the model has no `filters` knob)."""

  def create_module(self):
    return jax_models.Grasping44(
        num_convs=NUM_CONVS, filters=FILTERS, grasp_param_names=BLOCKS,
        dtype=self.compute_dtype if self.use_bfloat16 else None)


class _Critic(models.QTOptModel):

  def create_module(self):
    return models.Grasping44(
        image_size=SIZE, image_channels=3, grasp_param_size=5,
        num_convs=NUM_CONVS, filters=FILTERS, grasp_param_names=BLOCKS,
        dtype=self.compute_dtype if self.use_bfloat16 else None)


def _grasping44_models(use_bfloat16=False):
  kwargs = dict(image_size=SIZE, action_size=5, network="grasping44",
                grasp_param_names=BLOCKS, use_bfloat16=use_bfloat16)
  return _JaxCritic(device_type="cpu", **kwargs), _Critic(**kwargs)


def _small_models(use_bfloat16=False):
  kwargs = dict(image_size=32, action_size=4, network="small")
  return (jax_models.QTOptModel(device_type="cpu", **kwargs),
          models.QTOptModel(**kwargs))


@functools.lru_cache(maxsize=None)
def _setup(network, use_bfloat16=False):
  """(jax model, port model, jax state, port state, batch), built once
  per network and policy: the states are never modified."""
  jax_model, model = {"grasping44": _grasping44_models,
                      "small": _small_models}[network](use_bfloat16)
  features = _features(model)
  return (jax_model, model) + _states(jax_model, features) + (features,)


def _features(model, batch=2, seed=0):
  return dict(jax_specs.make_random_numpy(
      model.get_feature_specification("train"), batch_size=batch, seed=seed))


def _states(jax_model, features, seed=0):
  """The JAX model's initial state (its init, jitted: eager flax init
  compiles every op on its own) and the port's copy of it."""
  jax_state = jax.jit(lambda rng, f: jax_train_step.create_train_state(
      jax_model, rng, f)[0])(jax.random.PRNGKey(seed), features)
  return jax_state, bridge.train_state_from_jax(jax_state)


def _forward_both(jax_model, model, jax_state, state, features, train,
                  preprocess=True, jit=True):
  """(jax outputs, jax new batch_stats, port outputs, port new state) of
  each model's `inference_network_fn` on its own preprocessed batch (or
  on the raw batch: the preprocessors refuse a [B, A, P] action batch);
  the JAX function jitted or run eagerly."""
  jax_features = features
  port_features = {k: torch.from_numpy(np.asarray(v))
                   for k, v in features.items()}
  if preprocess:
    jax_features, _ = jax_model.preprocessor.preprocess(features, {},
                                                        "train")
    port_features, _ = model.preprocessor.preprocess(port_features, {},
                                                     "train")
  def jax_forward(variables, f):
    return jax_model.inference_network_fn(
        variables, jax_model.cast_features_for_compute(f), "train",
        train=train)

  out, new = (jax.jit(jax_forward) if jit else jax_forward)(
      {"params": jax_state.params, **jax_state.mutable_state},
      dict(jax_features))
  with torch.no_grad():
    port_out, port_new = model.inference_network_fn(
        state.params, state.mutable_state,
        model.cast_features_for_compute(port_features), "train",
        train=train)
  return out, new, port_out, port_new


def _f32(x):
  return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                    np.float32)


def _rel(got, want):
  got, want = _f32(got), _f32(want)
  return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_norm(got, want):
  got, want = _f32(got), _f32(want)
  return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _assert_stats_close(jax_new, port_new):
  want = bridge.mutable_state_from_flax(
      bridge._numpy_tree(jax_new["batch_stats"]))
  assert set(port_new) == set(want)
  for name, value in want.items():
    tol = (F32_CANCELLING_RTOL if name.endswith("running_mean")
           else STATS_VAR_RTOL)
    assert _rel(port_new[name], value) <= tol, name


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("size, kernel, stride, pads", [
    (472, 6, 2, (2, 2)),   # Grasping44's stem at the flagship width
    (236, 3, 3, (0, 1)),   # its first pool
    (79, 3, 3, (1, 1)),    # its second pool
    (27, 2, 2, (0, 1)),    # its third pool
    (32, 3, 2, (0, 1)),    # GraspingCNN's stride-2 conv, even
    (33, 3, 2, (1, 1)),    # ... odd
    (9, 5, 1, (2, 2)),     # a 5x5 conv
])
def test_same_padding_matches_lax(size, kernel, stride, pads):
  assert flax_layers.same_padding(size, kernel, stride) == pads
  rs = np.random.RandomState(size)
  x = rs.randn(1, size, size + 1, 2).astype(np.float32)  # NHWC, H != W
  w = rs.randn(kernel, kernel, 2, 3).astype(np.float32)  # HWIO
  want = jax.lax.conv_general_dilated(
      x, w, (stride, stride), "SAME",
      dimension_numbers=("NHWC", "HWIO", "NHWC"),
      precision=jax.lax.Precision.HIGHEST)
  got = flax_layers.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                           torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                           stride=stride)
  np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                             atol=1e-4, rtol=1e-5)
  pooled = flax_nn.max_pool(-np.abs(x), (kernel, kernel), (stride, stride),
                            padding="SAME")
  got_pool = flax_layers.max_pool(
      torch.from_numpy(-np.abs(x)).permute(0, 3, 1, 2), kernel, stride)
  np.testing.assert_array_equal(got_pool.permute(0, 2, 3, 1).numpy(),
                                np.asarray(pooled))


def test_norms_compute_in_at_least_float32():
  x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
  bn = flax_layers.BatchNorm(3, momentum=0.9997, epsilon=1e-3)
  for dtype, stats_dtype in ((torch.bfloat16, torch.float32),
                             (torch.float32, torch.float32),
                             (torch.float64, torch.float64)):
    mean, var = flax_layers.moments(x.to(dtype), (0, 2, 3))
    assert mean.dtype == var.dtype == stats_dtype
    state = {"weight": torch.ones(3, dtype=stats_dtype),
             "bias": torch.zeros(3, dtype=stats_dtype),
             "running_mean": torch.zeros(3, dtype=stats_dtype),
             "running_var": torch.ones(3, dtype=stats_dtype)}
    y, new = torch.func.functional_call(bn, state, (x.to(dtype), True))
    assert y.dtype == dtype and new["running_var"].dtype == stats_dtype
  want = x.double().var((0, 2, 3), unbiased=False)
  torch.testing.assert_close(var.reshape(-1), want, atol=1e-12, rtol=1e-12)


def test_trunc_normal_001_bounds_and_std():
  w = torch.empty(400, 250)
  models.trunc_normal_001_(w, torch.Generator().manual_seed(0))
  want = np.asarray(jax_models._TRUNC_NORMAL_001(
      jax.random.PRNGKey(0), (400, 250), jnp.float32))
  for values in (w.numpy(), want):
    assert values.min() >= -0.02 and values.max() <= 0.02
    assert values.std() == pytest.approx(0.0088, rel=0.02)
    assert abs(values.mean()) < 1e-4


def test_init_matches_the_flax_tree_and_initializers():
  _, model, _, want, _ = _setup("grasping44")
  params = model.init_params(torch.Generator().manual_seed(0))
  stats = model.init_mutable_state()
  assert set(params) == set(want.params)
  assert set(stats) == set(want.mutable_state)
  for name, value in params.items():
    assert value.shape == want.params[name].shape, name
    if name.endswith(".weight") and value.ndim > 1:  # conv / dense kernel
      assert 0 < float(value.abs().max()) <= 0.02, name
    elif name.endswith(".weight"):  # batch-norm scale
      assert torch.equal(value, torch.ones_like(value)), name
    else:
      assert torch.equal(value, torch.zeros_like(value)), name
  for name, value in stats.items():
    assert torch.equal(value, want.mutable_state[name]), name
  assert "conv1_bn.weight" not in params and "conv2_bn.weight" in params
  assert "fcgrasp_bn.weight" not in params and "conv2.bias" not in params
  assert "conv1_1.bias" in params and "logit.bias" in params
  # GraspingCNN: flax's lecun normal, LayerNorm at 1 and 0.
  _, small = _small_models()
  small_params = small.init_params(torch.Generator().manual_seed(0))
  stem = small_params["stem_0.weight"]
  assert stem.shape == (32, 3, 3, 3)
  assert float(stem.abs().max()) <= 2 / 27 ** 0.5 / 0.8796 + 1e-6
  assert small.init_mutable_state() == {}


# -- forward parity ----------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_grasping_cnn_matches_jax(train):
  out, new, port_out, port_new = _forward_both(*_setup("small"), train)
  assert port_out["q_predicted"].shape == (2, 1)
  assert _rel(port_out["q_predicted"], out["q_predicted"]) <= F32_RTOL
  assert port_new == {} and not new


@pytest.mark.parametrize("train", [False, True])
def test_grasping44_matches_jax(train):
  out, new, port_out, port_new = _forward_both(*_setup("grasping44"),
                                               train)
  for key in ("q_predicted", "logits"):
    assert port_out[key].shape == (2, 1)
    tol = F32_CANCELLING_RTOL if train and key == "logits" else F32_RTOL
    assert _rel(port_out[key], out[key]) <= tol, key
  if train:
    _assert_stats_close(new, port_new)
  else:
    assert port_new == {}


def test_bf16_policy_matches_jax():
  setup = _setup("grasping44", use_bfloat16=True)
  out, _, port_out, _ = _forward_both(*setup, train=False)
  assert port_out["logits"].dtype == torch.bfloat16
  assert _rel_norm(port_out["logits"], out["logits"]) <= BF16_EVAL_REL_NORM
  eager, _, port_out, _ = _forward_both(*setup, train=True, jit=False)
  jitted, _, _, _ = _forward_both(*setup, train=True)
  f32, _, _, _ = _forward_both(*_setup("grasping44"), train=True)
  yardstick = _rel_norm(jitted["logits"], eager["logits"])
  assert 0 < yardstick < 0.2 and _rel_norm(eager["logits"], f32["logits"]) > 0
  assert _rel_norm(port_out["logits"], eager["logits"]) <= yardstick


def test_the_jax_critic_computes_its_products_in_bf16_under_the_policy():
  """The reason the port casts every parameter for the critic too: the
  JAX model's `inference_network_fn` casts its whole `params` collection,
  so every convolution and product of the tower takes bf16 operands (the
  module applied alone to f32 parameters would promote to f32)."""
  jax_model, model, jax_state, state, features = _setup(
      "grasping44", use_bfloat16=True)
  jax_features, _ = jax_model.preprocessor.preprocess(features, {}, "train")
  jaxpr = jax.make_jaxpr(lambda params: jax_model.inference_network_fn(
      {"params": params, **jax_state.mutable_state},
      jax_model.cast_features_for_compute(dict(jax_features)), "train",
      train=True))(jax_state.params)
  operand_dtypes = [
      tuple(str(v.aval.dtype) for v in eqn.invars)
      for eqn in jaxpr.jaxpr.eqns
      if eqn.primitive.name in ("conv_general_dilated", "dot_general")]
  assert len(operand_dtypes) == 6 + 7  # convs; blocks, fcgrasp2/proj, fc, logit
  assert set(operand_dtypes) == {("bfloat16", "bfloat16")}
  cast = model.params_for_compute(state.params)
  assert {v.dtype for v in cast.values()} == {torch.bfloat16}


def test_cem_megabatch_matches_jax_and_the_flat_batch():
  jax_model, model, jax_state, state, features = _setup("grasping44")
  b, a = 2, 6
  mega = dict(features)
  mega["action/action"] = np.random.RandomState(1).rand(b, a, 5).astype(
      np.float32)
  out, _, port_out, _ = _forward_both(jax_model, model, jax_state, state,
                                      mega, train=False, preprocess=False)
  assert port_out["q_predicted"].shape == (b, a)
  assert port_out["logits"].shape == (b, a, 1)
  for key in ("q_predicted", "logits"):
    assert _rel(port_out[key], out[key]) <= F32_RTOL, key
  flat = {"state/image": np.repeat(features["state/image"], a, axis=0),
          "action/action": mega["action/action"].reshape(b * a, 5)}
  _, _, flat_out, _ = _forward_both(jax_model, model, jax_state, state, flat,
                                    train=False)
  np.testing.assert_array_equal(port_out["q_predicted"].numpy().reshape(-1),
                                flat_out["q_predicted"].numpy().reshape(-1))


def test_cem_megabatch_broadcasts_state_vectors():
  kwargs = dict(image_size=SIZE, action_size=5, network="grasping44",
                grasp_param_names=BLOCKS, extra_state_vector_size=3)

  class Critic(models.QTOptModel):

    def create_module(self):
      return models.Grasping44(
          image_size=SIZE, image_channels=3, grasp_param_size=8,
          num_convs=NUM_CONVS, filters=FILTERS,
          grasp_param_names={"all": (0, 8)})

  model = Critic(**kwargs)
  params = model.init_params(torch.Generator().manual_seed(0))
  stats = model.init_mutable_state()
  features = {k: torch.from_numpy(np.asarray(v))
              for k, v in _features(model).items()}
  b, a = 2, 4
  mega = dict(features)
  mega["action/action"] = torch.rand(b, a, 5,
                                     generator=torch.Generator().manual_seed(2))
  flat = {"state/image": features["state/image"].repeat_interleave(a, 0),
          "state/params": features["state/params"].repeat_interleave(a, 0),
          "action/action": mega["action/action"].reshape(b * a, 5)}
  with torch.no_grad():
    got, _ = model.inference_network_fn(params, stats, mega, "predict")
    want, _ = model.inference_network_fn(params, stats, flat, "predict")
  assert got["q_predicted"].shape == (b, a)
  torch.testing.assert_close(got["q_predicted"].reshape(-1),
                             want["q_predicted"].reshape(-1), atol=0, rtol=0)


def test_goal_merges_widen_fc0_and_match_jax():
  rs = np.random.RandomState(3)
  features = {"state/image": rs.randint(0, 255, (2, SIZE, SIZE, 3)).astype(
      np.uint8), "action/action": rs.rand(2, 5).astype(np.float32)}
  # One goal for the batch, tiled over it; the tower ends at 2x2 here.
  goals = {"goal_vector": rs.randn(1, 8).astype(np.float32),
           "goal_spatial": rs.randn(1, 2, 2, 4).astype(np.float32)}
  module = jax_models.Grasping44(num_convs=NUM_CONVS, filters=FILTERS,
                                grasp_param_names=BLOCKS)
  variables = jax.jit(functools.partial(module.init, **goals))(
      jax.random.PRNGKey(0), features)
  want = jax.jit(functools.partial(module.apply, train=False, **goals))(
      variables, features)
  port = models.Grasping44(SIZE, 3, 5, num_convs=NUM_CONVS, filters=FILTERS,
                           grasp_param_names=BLOCKS, goal_vector_size=8,
                           goal_spatial_channels=4)
  plain = models.Grasping44(SIZE, 3, 5, num_convs=NUM_CONVS, filters=FILTERS,
                            grasp_param_names=BLOCKS)
  assert port.fc0.in_features == plain.fc0.in_features + 8 + 2 * 2 * 4
  tree = bridge._numpy_tree(variables)
  weights = {**bridge.state_dict_from_flax(tree["params"]),
             **bridge.mutable_state_from_flax(tree["batch_stats"])}
  with torch.no_grad():
    got, _ = torch.func.functional_call(
        port, weights, ({k: torch.from_numpy(v) for k, v in features.items()},),
        {k: torch.from_numpy(v) for k, v in goals.items()})
  assert _rel(got["logits"], want["logits"]) <= F32_RTOL


def test_flagship_widths_and_unported_knobs():
  model = flagship.make_flagship_model()
  module = model.module
  assert (model.network, model.use_bfloat16, model.use_ema) == (
      "grasping44", True, True)
  convs = [n for n, m in module.named_modules()
           if isinstance(m, torch.nn.Conv2d)]
  assert len(convs) == 16  # conv1_1 + conv2..conv16
  assert module.fc0.in_features == 8 * 8 * 64
  assert module.world_vector.in_features == 3
  assert module.vertical_rotation.in_features == 2
  small = flagship.make_flagship_model("cpu")
  assert small.network == "small" and not small.use_bfloat16
  # The s2d stem is ported (tests/test_torch_s2d.py); an odd image
  # raises, as in the JAX package.
  s2d = models.Grasping44(SIZE, 3, 5, space_to_depth=True)
  assert s2d.conv1_1_s2d.weight.shape == (64, 12, 3, 3)
  with pytest.raises(ValueError, match="even spatial dims"):
    models.space_to_depth(torch.zeros(1, 3, 5, 6))
  with pytest.raises(ValueError, match="network"):
    models.QTOptModel(network="nope")
