"""Sequence parallelism in the port against the JAX package: ring and
Ulysses attention, their train steps, and the composite (data 2, fsdp 2,
sp 2) step.

The JAX side runs here on the 8 virtual CPU devices of conftest.py; the
port's runs in one 8-rank gloo world (`test_torch_mesh_world`, cases in
`test_torch_mesh_cases.sequence_parallel_world`), on the same numpy inputs,
the weights carried across by `bridge.py`. Mirrors tests/test_attention.py
(TestRingAttention, TestUlyssesAttention, TestRingChunking,
TestSequenceParallelTrainStep, TestCompositeParallelTrainStep) at its
shapes; each port result is held to the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu.models import sequence_model as jax_sequence_model
from tensor2robot_tpu.ops import attention as jax_attention
from tensor2robot_tpu.parallel import mesh as jax_mesh
from tensor2robot_tpu.parallel import train_step as jax_ts
from tensor2robot_tpu_torch import bridge
from tests import test_torch_mesh_world as torch_mesh_world

torch.set_num_threads(1)

ATOL = 2e-5
STEP_RTOL = 1e-4  # loss, relative (the JAX test's)
STEP_ATOL = 1e-4  # every updated leaf (the JAX test's)
QKV_SHAPES = ((2, 2, 32, 8), (2, 8, 32, 8), (2, 4, 32, 8), (2, 1, 16, 4),
              (2, 8, 16, 4))
SEQ_WIDTHS = dict(obs_size=6, action_size=3, sequence_length=16,
                  hidden_size=16, num_blocks=2, num_heads=2)


def _qkv(shape, seed=0):
  rng = np.random.RandomState(seed)
  return tuple(rng.randn(*shape).astype(np.float32) for _ in range(3))


def _jax_seq_model(backend, **kwargs):
  widths = {**SEQ_WIDTHS, **kwargs}
  return jax_sequence_model.SequenceRegressionModel(
      attention_backend=backend, device_type="cpu",
      optimizer_fn=lambda: optax.sgd(1e-2), **widths)


def _seq_batch(model, batch_size=8):
  features = jax_specs.make_random_numpy(
      model.get_feature_specification("train"), batch_size=batch_size,
      seed=0)
  labels = jax_specs.make_random_numpy(
      model.get_label_specification("train"), batch_size=batch_size, seed=1)
  return ({k: np.asarray(v) for k, v in features.items()},
          {k: np.asarray(v) for k, v in labels.items()})


def _jax_step(backend, mesh_shape=None, axis_names=None, rules=None,
              **kwargs):
  """(loss, new params as the port's state_dict, shardings) of one JAX
  step from PRNGKey(0) on the shared batch."""
  model = _jax_seq_model(backend, **kwargs)
  features, labels = _seq_batch(model)
  if mesh_shape is None:
    state, shardings = jax_ts.create_train_state(model, jax.random.PRNGKey(0),
                                                 features)
    step = jax_ts.make_train_step(model, donate=False)
    f, l = features, labels
  else:
    mesh = jax_mesh.create_mesh(mesh_shape=mesh_shape, axis_names=axis_names)
    model.set_mesh(mesh)
    state, shardings = jax_ts.create_train_state(
        model, jax.random.PRNGKey(0), features, mesh=mesh, rules=rules)
    step = jax_ts.make_train_step(model, mesh=mesh, shardings=shardings,
                                  batch_spec=model.batch_partition_spec,
                                  donate=False)
    f = jax_mesh.put_host_batch(mesh, features,
                                batch_spec=model.batch_partition_spec)
    l = jax_mesh.put_host_batch(mesh, labels,
                                batch_spec=model.batch_partition_spec)
  new_state, metrics = step(state, f, l)
  params = bridge.state_dict_from_flax(jax.device_get(new_state.params))
  return (float(metrics["loss"]), {k: v.numpy() for k, v in params.items()},
          shardings, state)


def _port_specs(flax_shardings) -> dict:
  """The port's sharded leaves, {state_dict name: spec}, that a JAX
  shardings tree of flax params gives: a Dense kernel [in, out] is the
  port's weight [out, in], so its spec reverses; a bias as it is."""
  out = {}

  def visit(tree, path):
    for key, value in tree.items():
      if isinstance(value, dict):
        visit(value, path + (key,))
        continue
      spec = tuple(value.spec)
      if not any(spec):
        continue
      name = ".".join(path + ({"kernel": "weight", "scale": "weight"}
                              .get(key, key),))
      if key == "kernel":
        spec = tuple(reversed(spec + (None,) * (2 - len(spec))))
      out[name] = spec

  visit(jax.device_get(flax_shardings), ())
  return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
  """The port's 8-rank world, started on JAX's init before the JAX side
  computes its results, so the two overlap."""
  model = _jax_seq_model("reference")
  features, labels = _seq_batch(model)
  state, _ = jax_ts.create_train_state(model, jax.random.PRNGKey(0), features)
  init = {k: v.numpy() for k, v in bridge.state_dict_from_flax(
      jax.device_get(state.params)).items()}
  payload = {f"qkv_{'_'.join(map(str, s))}": _qkv(s) for s in QKV_SHAPES}
  payload.update(module_x=np.random.RandomState(0).randn(2, 16, 12).astype(
      np.float32), seq_params=init, seq_features=features, seq_labels=labels)
  return torch_mesh_world.World(
      8, "tests.test_torch_mesh_cases:sequence_parallel_world", payload,
      tmp_path_factory.mktemp("sp_world"))


@pytest.fixture(scope="module")
def jax_side(world):
  """The JAX package's results on the 8 virtual devices."""
  sp_mesh = jax_mesh.create_mesh(mesh_shape=(2, 4, 1),
                                 axis_names=("data", "sp", "model"))
  qkv = {shape: tuple(map(jnp.asarray, _qkv(shape))) for shape in QKV_SHAPES}

  def run(fn, shape):
    return jax.jit(fn)(*qkv[shape])

  def ring(causal=True, **kwargs):
    return lambda q, k, v: jax_attention.ring_attention(
        q, k, v, sp_mesh, causal=causal, **kwargs)

  def ulysses(causal=True, **kwargs):
    return lambda q, k, v: jax_attention.ulysses_attention(
        q, k, v, sp_mesh, causal=causal, **kwargs)

  def grads(fn, shape):
    return run(jax.grad(lambda q, k, v: fn(q, k, v).sum(),
                        argnums=(0, 1, 2)), shape)

  out = {}
  for causal in (False, True):
    out[f"ring_causal{causal}"] = run(ring(causal), (2, 2, 32, 8))
    out[f"ring_chunked_causal{causal}"] = run(ring(causal, block_k=4),
                                              (2, 2, 32, 8))
    out[f"reference_causal{causal}"] = run(
        lambda q, k, v, c=causal: jax_attention.attention(q, k, v, causal=c),
        (2, 2, 32, 8))
    out[f"ulysses_causal{causal}"] = run(ulysses(causal), (2, 8, 32, 8))
  out["ring_h4"] = run(ring(), (2, 4, 32, 8))
  out["ulysses_h4"] = run(ulysses(), (2, 4, 32, 8))
  out["ulysses_flash_h4"] = run(ulysses(inner="flash"), (2, 4, 32, 8))
  out["ring_grads"] = grads(ring(), (2, 1, 16, 4))
  out["ulysses_grads"] = grads(ulysses(), (2, 8, 16, 4))
  out["ring_chunked_grads"] = grads(ring(block_k=2), (2, 1, 16, 4))
  out = {k: jax.device_get(v) for k, v in out.items()}
  sp = dict(mesh_shape=(2, 2, 1), axis_names=("data", "sp", "model"))
  for name, backend, kwargs in (
      ("ring", "ring", sp), ("ulysses", "ulysses", sp),
      ("ulysses_flash", "ulysses", {**sp, "ulysses_inner": "flash"}),
      ("composite", "ring", dict(mesh_shape=(2, 2, 2),
                                 axis_names=("data", "fsdp", "sp"),
                                 rules=jax_ts.fsdp_rules()))):
    loss, params, shardings, _ = _jax_step(backend, **kwargs)
    out[f"step_{name}"] = (loss, params)
    if name == "composite":
      out["composite_specs"] = _port_specs(shardings.params)
  loss, params, _, _ = _jax_step("reference")
  out["step_reference"] = (loss, params)
  return out


@pytest.fixture(scope="module")
def port(world, jax_side):
  """rank 0's results of the port's world."""
  del jax_side  # computed while the world runs
  return world.results()[0]


def _close(got, want, atol=ATOL):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                             rtol=atol)


class TestRingAttention:

  @pytest.mark.parametrize("causal", [False, True])
  def test_matches_jax_and_reference(self, port, jax_side, causal):
    _close(port[f"ring_causal{causal}"], jax_side[f"ring_causal{causal}"])
    _close(port[f"ring_causal{causal}"],
           jax_side[f"reference_causal{causal}"])

  def test_grads_match_jax(self, port, jax_side):
    for got, want in zip(port["ring_grads"], jax_side["ring_grads"]):
      assert np.isfinite(got).all()
      _close(got, want)


class TestUlyssesAttention:

  @pytest.mark.parametrize("causal", [False, True])
  def test_matches_jax(self, port, jax_side, causal):
    _close(port[f"ulysses_causal{causal}"],
           jax_side[f"ulysses_causal{causal}"])

  def test_matches_ring(self, port, jax_side):
    _close(port["ulysses_h4"], port["ring_h4"])
    _close(port["ulysses_h4"], jax_side["ulysses_h4"])

  def test_grads_match_jax(self, port, jax_side):
    for got, want in zip(port["ulysses_grads"], jax_side["ulysses_grads"]):
      _close(got, want)

  def test_flash_inner(self, port, jax_side):
    # The port's flash on the CPU is its kernels' plain version; JAX's is
    # the Pallas kernel in interpret mode.
    _close(port["ulysses_flash_h4"], jax_side["ulysses_flash_h4"], atol=1e-4)

  def test_rejects_indivisible_heads(self, port):
    raised, message = port["indivisible_heads"]
    assert raised and "divisible" in message


class TestRingChunking:

  @pytest.mark.parametrize("causal", [False, True])
  def test_chunked_hops_match(self, port, jax_side, causal):
    _close(port[f"ring_chunked_causal{causal}"],
           jax_side[f"ring_chunked_causal{causal}"])
    _close(port[f"ring_chunked_causal{causal}"],
           port[f"ring_causal{causal}"])

  def test_chunked_grads_match_jax(self, port, jax_side):
    for got, want in zip(port["ring_chunked_grads"],
                         jax_side["ring_chunked_grads"]):
      _close(got, want, atol=2e-4)

  def test_bad_block_k_raises(self, port):
    raised, message = port["bad_block_k"]
    assert raised and "block_k" in message


def test_multi_head_attention_ring_matches_reference(port):
  _close(port["module_ring"], port["module_reference"])


def _step_matches(port_step, jax_step):
  loss, params = jax_step
  assert port_step["losses"][0] == pytest.approx(loss, rel=STEP_RTOL)
  assert set(port_step["params"]) == set(params)
  for name, value in params.items():
    np.testing.assert_allclose(port_step["params"][name], value,
                               atol=STEP_ATOL, err_msg=name)


class TestSequenceParallelTrainStep:

  @pytest.mark.parametrize("name", ["ring", "ulysses", "ulysses_flash"])
  def test_step_matches_jax(self, port, jax_side, name):
    _step_matches(port[f"step_{name}"], jax_side[f"step_{name}"])
    # and the single-device reference step
    _step_matches(port[f"step_{name}"], jax_side["step_reference"])

  def test_sp_training_decreases_loss(self, port):
    losses = port["ring_30_steps"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses

  def test_set_mesh_validation(self, port):
    checks = port["set_mesh"]
    assert checks["seq15"][0] and "not divisible" in checks["seq15"][1]
    assert checks["no_sp"][0] and "mesh axis" in checks["no_sp"][1]
    assert checks["no_mesh"][0] and "set_mesh" in checks["no_mesh"][1]
    assert checks["heads3"][0] and "num_heads" in checks["heads3"][1]


class TestCompositeParallelTrainStep:

  def test_dp_fsdp_sp_step_matches_jax(self, port, jax_side):
    _step_matches(port["step_composite"], jax_side["step_composite"])
    _step_matches(port["step_composite"], jax_side["step_reference"])

  def test_shards_the_leaves_and_dims_jax_shards(self, port, jax_side):
    sharded = port["step_composite"]["sharded"]
    assert sharded, "no leaf took the fsdp axis"
    assert sharded == jax_side["composite_specs"]
