"""The port's mesh, data parallelism, FSDP, spec sharding and
checkpoints across mesh shapes, against the JAX package.

The JAX side runs here on the 8 virtual CPU devices of conftest.py; the
port's runs in one 8-rank gloo world (`test_torch_mesh_world`, cases in
`test_torch_mesh_cases.mesh_world`), on the same numpy batches, the JAX
package's init carried across by `bridge.py`. Mirrors
tests/test_train_step.py (TestMeshConstruction, TestTrainStep under a
2-rank data mesh, TestShardingRules) and the sharding helpers of
tests/test_specs.py. A single process with no process group gets a mesh
of size 1, whose step is the single-device step.
"""

import types

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from tensor2robot_tpu import checkpoints as jax_checkpoints
from tensor2robot_tpu import modes as jax_modes
from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu.models import sequence_model as jax_sequence_model
from tensor2robot_tpu.parallel import mesh as jax_mesh
from tensor2robot_tpu.parallel import train_step as jax_ts
from tensor2robot_tpu.utils import mocks as jax_mocks
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch import checkpoints
from tensor2robot_tpu_torch import specs
from tensor2robot_tpu_torch.models import optimizers as port_optimizers
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.utils import mocks
from tests import test_torch_mesh_world as torch_mesh_world

torch.set_num_threads(1)

STEP_RTOL = 1e-4
STEP_ATOL = 1e-4
STATS_ATOL = 1e-5


def _tensor_leaves(state):
  """The tensors of the parameters, the optimizer state and the EMA, in
  a fixed order (the batch-norm statistics are replaced every step)."""
  leaves = []

  def walk(tree):
    if isinstance(tree, torch.Tensor):
      leaves.append(tree)
    elif isinstance(tree, dict):
      for key in sorted(tree):
        walk(tree[key])
    elif isinstance(tree, (tuple, list)):
      for value in tree:
        walk(value)

  walk((state.params, state.opt_state, state.ema_params))
  return leaves


def _mock_batch(batch_size=32):
  generator = jax_mocks.MockInputGenerator(batch_size=batch_size)
  generator.set_specification_from_model(
      jax_mocks.MockT2RModel(device_type="cpu"), jax_modes.TRAIN)
  batch = next(generator.create_dataset(jax_modes.TRAIN))
  return ({k: np.asarray(v) for k, v in batch["features"].items()},
          {k: np.asarray(v) for k, v in batch["labels"].items()})


def _jax_mock_step(mesh_shape, rules=None, optimizer_fn=None):
  # SGD, as the JAX package's own parity tests: Adam turns the f32
  # noise of gradients that are zero in exact arithmetic (a Dense bias
  # before batch norm) into steps of the learning rate.
  model = jax_mocks.MockT2RModel(
      device_type="cpu", optimizer_fn=optimizer_fn or (lambda: optax.sgd(
          1e-2)))
  features, labels = _mock_batch()
  mesh = jax_mesh.create_mesh(mesh_shape=mesh_shape)
  state, shardings = jax_ts.create_train_state(
      model, jax.random.PRNGKey(0), features, mesh=mesh, rules=rules)
  step = jax_ts.make_train_step(model, mesh=mesh, shardings=shardings,
                                donate=False)
  new, metrics = step(state, jax_mesh.put_host_batch(mesh, features),
                      jax_mesh.put_host_batch(mesh, labels))
  return {"loss": float(metrics["loss"]),
          "norm": float(metrics["global_gradient_norm"]),
          "params": {k: v.numpy() for k, v in bridge.state_dict_from_flax(
              jax.device_get(new.params)).items()},
          "mutable": {k: v.numpy() for k, v in bridge.mutable_state_from_flax(
              jax.device_get(new.mutable_state["batch_stats"])).items()},
          "init": state, "shardings": shardings}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
  """The port's 8-rank world, started on JAX's init before the JAX side
  computes its results."""
  model = jax_mocks.MockT2RModel(device_type="cpu")
  features, labels = _mock_batch()
  state, _ = jax_ts.create_train_state(model, jax.random.PRNGKey(0),
                                       features)
  payload = {
      "mock_params": {k: v.numpy() for k, v in bridge.state_dict_from_flax(
          jax.device_get(state.params)).items()},
      "mock_mutable": {k: v.numpy() for k, v in
                       bridge.mutable_state_from_flax(jax.device_get(
                           state.mutable_state["batch_stats"])).items()},
      "mock_features": features, "mock_labels": labels,
      "checkpoint_dir": str(tmp_path_factory.mktemp("ckpt"))}
  return torch_mesh_world.World(8, "tests.test_torch_mesh_cases:mesh_world",
                                payload, tmp_path_factory.mktemp("world"))


@pytest.fixture(scope="module")
def jax_side(world):
  del world  # started first: the two overlap
  return {"dp": _jax_mock_step((2, 1, 1)),
          "fsdp": _jax_mock_step((2, 4, 1), jax_ts.fsdp_rules(), lambda:
                                 optax.chain(optax.clip_by_global_norm(0.05),
                                             optax.sgd(1e-2, momentum=0.9)))}


@pytest.fixture(scope="module")
def ranks(world, jax_side):
  del jax_side
  return world.results()


@pytest.fixture(scope="module")
def port(ranks):
  return ranks[0]


def _params_close(got, want, atol=STEP_ATOL):
  assert set(got) == set(want)
  for name, value in want.items():
    np.testing.assert_allclose(got[name], value, atol=atol, err_msg=name)


class TestMeshConstruction:

  def test_default_mesh_all_data(self, port):
    assert port["construction"]["default"] == {"data": 8, "fsdp": 1,
                                               "model": 1}

  def test_explicit_shapes(self, port):
    assert port["construction"]["explicit"] == {"data": 2, "fsdp": 2,
                                                "model": 2}

  def test_too_large_shape_raises(self, port):
    raised, message = port["construction"]["too_large"]
    assert raised and "cover" in message

  def test_smaller_shape_uses_rank_prefix(self, ranks):
    assert all(r["construction"]["prefix_size"] == 2 for r in ranks)
    assert [r["construction"]["prefix_in_mesh"] for r in ranks] == (
        [True] * 2 + [False] * 6)

  def test_local_batch_size(self, port):
    # One process per rank: 8 processes share the global batch.
    assert port["construction"]["local_batch_size"] == 4
    single = mesh_lib.create_mesh(device="cpu")
    assert single.size == 1 and mesh_lib.local_batch_size(32, single) == 32

  def test_size_one_mesh_without_a_world(self):
    mesh = mesh_lib.create_mesh(device="cpu")
    assert dict(mesh.shape) == {"data": 1, "fsdp": 1, "model": 1}
    assert mesh.is_primary and mesh.in_mesh and mesh.axis_index("data") == 0
    assert mesh_lib.data_sharding(mesh).spec == ("data",)
    assert mesh_lib.replicated(mesh).spec == ()
    assert mesh.agree(True, False) == (True, False)
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(mesh_lib.unshard(mesh_lib.shard(x, mesh, ("data",)),
                                        mesh, ("data",)), x)

  def test_put_host_batch_shards_leading_dim(self, ranks):
    full = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    for rank, result in enumerate(ranks):
      np.testing.assert_array_equal(result["construction"]["put_host_batch"],
                                    full[2 * rank:2 * rank + 2])


class TestTrainStep:
  """The mock classifier (batch norm included) on a 2-rank data mesh."""

  def test_step_matches_jax(self, port, jax_side):
    want = jax_side["dp"]
    got = port["dp_step"]
    assert got["loss"] == pytest.approx(want["loss"], rel=STEP_RTOL)
    assert got["norm"] == pytest.approx(want["norm"], rel=STEP_RTOL)
    _params_close(got["params"], want["params"])
    # Batch statistics over the whole sharded batch, as under jit.
    _params_close(got["mutable_state"], want["mutable"], atol=STATS_ATOL)
    assert port["dp_input_unchanged"]

  def test_loss_decreases_dp(self, port):
    losses = port["dp_losses"]
    assert losses[-1] < losses[0] * 0.5, losses[::50]
    assert port["dp_step_count"] == 200

  def test_donated_state_is_written_in_place(self, port):
    assert port["dp_donated"]

  def test_metrics_replicated_and_finite(self, ranks):
    values = [r["dp_metric"] for r in ranks[:2]]
    assert np.isfinite(values).all() and values[0] == values[1]

  def test_ema_tracks_params(self, port):
    assert port["dp_ema_moved_apart"]

  def test_eval_step_accuracy(self, port):
    assert port["dp_accuracy"] > 0.9

  def test_predict_fn(self, port):
    assert port["dp_predict_shape"] == (32, 1)

  def test_bfloat16_compute(self, port):
    loss, dtype = port["dp_bf16"]
    assert np.isfinite(loss) and dtype == "torch.float32"

  def test_size_one_mesh_step_is_the_single_device_step(self):
    model = mocks.MockT2RModel()
    features, labels = _mock_batch()
    features = {k: torch.from_numpy(v) for k, v in features.items()}
    labels = {k: torch.from_numpy(v) for k, v in labels.items()}
    state = ts.create_train_state(model, torch.Generator().manual_seed(0),
                                  torch.device("cpu"))
    plain, plain_metrics = ts.make_train_step(model)(state, features, labels)
    mesh = mesh_lib.create_mesh((1, 1, 1), device="cpu")
    sharded, shardings = ts.create_train_state(
        model, torch.Generator().manual_seed(0), torch.device("cpu"),
        mesh=mesh, rules=ts.fsdp_rules())
    f, l = mesh_lib.place_batch(mesh, {"features": features,
                                       "labels": labels})
    new, metrics = ts.make_train_step(model, mesh=mesh,
                                      shardings=shardings)(sharded, f, l)
    assert float(metrics["loss"]) == float(plain_metrics["loss"])
    for name, value in plain.params.items():
      torch.testing.assert_close(new.params[name], value, rtol=0, atol=0)

  @pytest.mark.parametrize("optimizer_fn, knobs", [
      (lambda: port_optimizers.create_adam_optimizer(1e-2, gradient_clip_norm=
                                                     0.5), {"use_ema": True}),
      (lambda: port_optimizers.create_momentum_optimizer(
          1e-2, 0.9, use_nesterov=True), {}),
      (lambda: port_optimizers.create_rms_prop_optimizer(1e-2), {}),
      (lambda: port_optimizers.create_sgd_optimizer(1e-1),
       {"use_ema": True, "ema_decay": 0.9, "gradient_accumulation_steps": 2}),
  ], ids=["adam_clip_ema", "nesterov", "rmsprop", "sgd_accumulated_ema"])
  def test_donated_step_updates_in_place_to_the_same_bits(self, optimizer_fn,
                                                          knobs):
    model = mocks.MockT2RModel(optimizer_fn=optimizer_fn, **knobs)
    batches = [tuple({k: torch.from_numpy(v) for k, v in part.items()}
                     for part in _mock_batch()) for _ in range(5)]
    mesh = mesh_lib.create_mesh((1, 1, 1), device="cpu")
    states = {}
    for donate in (False, True):
      state, shardings = ts.create_train_state(
          model, torch.Generator().manual_seed(0), torch.device("cpu"),
          mesh=mesh, rules=ts.fsdp_rules())
      step = ts.make_train_step(model, mesh=mesh, shardings=shardings,
                                donate=donate)
      for features, labels in batches:
        given = state
        before = [t.clone() for t in _tensor_leaves(given)]
        state, _ = step(state, *mesh_lib.place_batch(
            mesh, {"features": features, "labels": labels}))
        old, new = _tensor_leaves(given), _tensor_leaves(state)
        if donate:  # the state's own tensors hold the new values
          assert all(a is b for a, b in zip(old, new))
        else:  # the state the step was given is as it was
          assert all(torch.equal(a, b) for a, b in zip(old, before))
      states[donate] = _tensor_leaves(state)
    for kept, donated in zip(states[False], states[True]):
      assert torch.equal(kept, donated)


class TestShardingRules:

  @pytest.mark.parametrize("mesh_shape", [(2, 4, 1), (1, 2, 1), (1, 8, 1)])
  def test_fsdp_rules_shard_the_dims_jax_shards(self, mesh_shape):
    """Leaf by leaf, the port's `_leaf_partition` picks the logical dim
    JAX's picks (the port's Dense weight is flax's kernel transposed)."""
    mesh = jax_mesh.create_mesh(mesh_shape=mesh_shape)
    port_mesh = types.SimpleNamespace(shape=dict(mesh.shape))
    for model, port_model in (
        (jax_mocks.MockT2RModel(device_type="cpu"), mocks.MockT2RModel()),
        (jax_sequence_model.SequenceRegressionModel(device_type="cpu"),
         sequence_model.SequenceRegressionModel())):
      features = jax_specs.make_random_numpy(
          model.get_feature_specification("train"), batch_size=2)
      abstract = jax.eval_shape(
          lambda: model.init_variables(jax.random.PRNGKey(0), features,
                                       mode="train")["params"])
      want = {}

      def visit(tree, path):
        for key, value in tree.items():
          if isinstance(value, dict):
            visit(value, path + (key,))
            continue
          spec = tuple(jax_ts._leaf_partition(
              "params/" + "/".join(path + (key,)), value.shape,
              jax_ts.fsdp_rules(), mesh))
          spec = spec + (None,) * (len(value.shape) - len(spec))
          name = ".".join(path + ({"kernel": "weight", "scale": "weight"}
                                  .get(key, key),))
          want[name] = tuple(reversed(spec)) if key == "kernel" else spec

      visit(abstract, ())
      params = port_model.init_params(torch.Generator().manual_seed(0))
      got = {}
      for name, value in params.items():
        spec = tuple(ts._leaf_partition(f"params/{name}", tuple(value.shape),
                                        ts.fsdp_rules(), port_mesh))
        got[name] = spec + (None,) * (value.ndim - len(spec))
      assert got == want

  def test_fsdp_step_matches_jax(self, port, jax_side):
    got, want = port["fsdp_step"], jax_side["fsdp"]
    assert got["loss"] == pytest.approx(want["loss"], rel=STEP_RTOL)
    assert want["norm"] > 0.05  # the clip scaled this step's update
    _params_close(got["params"], want["params"])
    sharded = {k: v for k, v in got["specs"].items() if v}
    assert "dense_0.weight" in sharded or "dense_1.weight" in sharded
    for name, spec in sharded.items():
      full = got["params"][name].shape
      local = got["local_shapes"][name]
      dim = spec.index("fsdp")
      assert local[dim] * 4 == full[dim], (name, local, full)
      # The optimizer's moments follow their parameter.
      assert got["local_moments"]
      for moments in got["local_moments"]:
        assert moments[name] == local

  def test_explicit_rule_partition(self):
    mesh = types.SimpleNamespace(shape={"data": 2, "fsdp": 1, "model": 4})
    spec = ts._leaf_partition("dense.weight", (16, 32),
                              ((r"weight", (None, "model")),), mesh)
    assert spec == mesh_lib.PartitionSpec(None, "model")

  def test_rule_shape_mismatch_falls_back_replicated(self):
    mesh = types.SimpleNamespace(shape={"data": 2, "fsdp": 1, "model": 4})
    spec = ts._leaf_partition("dense.bias", (16,),
                              ((r".*", (None, "model")),), mesh)
    assert spec == mesh_lib.PartitionSpec()


class TestCheckpointAcrossMeshShapes:

  def test_save_on_fsdp_restore_on_data_mesh(self, port):
    case = port["checkpoint"]
    assert case["saved"] and case["sharded_leaves"]
    assert case["restored_step"] == case["saved_state"]["step"]
    for field in ("params", "opt_state", "mutable_state"):
      jax.tree_util.tree_map(np.testing.assert_array_equal,
                             case["restored_data_mesh"][field],
                             case["saved_state"][field])

  def test_restore_on_one_process(self, port):
    case = port["checkpoint"]
    state = checkpoints.CheckpointManager(case["directory"]).restore()
    host = bridge.state_to_numpy(state)
    for field in ("params", "opt_state", "mutable_state"):
      jax.tree_util.tree_map(np.testing.assert_array_equal, host[field],
                             case["saved_state"][field])

  def test_jax_restore_across_meshes_matches(self, tmp_path):
    """The JAX package's own semantics: a state saved sharded over fsdp
    restores onto a data mesh bit for bit."""
    model = jax_mocks.MockT2RModel(device_type="cpu")
    features, _ = _mock_batch()
    fsdp = jax_mesh.create_mesh(mesh_shape=(1, 2, 1))
    state, _ = jax_ts.create_train_state(model, jax.random.PRNGKey(0),
                                         features, mesh=fsdp,
                                         rules=jax_ts.fsdp_rules())
    manager = jax_checkpoints.CheckpointManager(str(tmp_path),
                                                async_checkpointing=False)
    manager.save(1, state)
    manager.wait_until_finished()
    data = jax_mesh.create_mesh(mesh_shape=(2, 1, 1))
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(
            x.shape, x.dtype, sharding=NamedSharding(data, PartitionSpec())),
        state)
    restored = manager.restore(1, abstract_state=abstract)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)),
        restored.params, state.params)


class TestCollectives:

  def test_staged_transport_matches_the_direct_one(self, ranks):
    for result in ranks:
      case = result["collectives"]
      # Only P2P (`ppermute`) is staged.
      assert case["stagedFalse_calls"] == 0 and case["stagedTrue_calls"] == 1
      for got, want in zip(case["stagedTrue"], case["stagedFalse"]):
        np.testing.assert_array_equal(got, want)

  def test_collective_values(self, ranks):
    x = [np.arange(24, dtype=np.float32).reshape(8, 3) + 100 * r
         for r in range(8)]
    for rank, result in enumerate(ranks):
      total, top, gathered, scattered, exchanged, permuted, broadcast = (
          result["collectives"]["stagedFalse"])
      np.testing.assert_array_equal(total, sum(x))
      np.testing.assert_array_equal(top, x[7])
      np.testing.assert_array_equal(gathered, np.concatenate(x, axis=1))
      np.testing.assert_array_equal(scattered, sum(x)[rank:rank + 1])
      np.testing.assert_array_equal(
          exchanged, np.stack([x[src].reshape(8, -1, 3)[rank]
                               for src in range(8)]))
      np.testing.assert_array_equal(permuted, x[(rank - 1) % 8])
      np.testing.assert_array_equal(broadcast, x[1])


class TestSpecSharding:

  def _pair(self, **kwargs):
    return (jax_specs.TensorSpec(shape=(4, 5), dtype=np.float32, name="x",
                                 **kwargs),
            specs.TensorSpec(shape=(4, 5), dtype=np.float32, name="x",
                             **kwargs))

  def test_to_dict_and_from_dict_keep_sharding(self):
    jax_spec, port_spec = self._pair(sharding=(None, "model"))
    assert port_spec.to_dict() == jax_spec.to_dict()
    back = specs.TensorSpec.from_dict(jax_spec.to_dict())
    assert back.sharding == (None, "model") and back == port_spec
    assert port_spec.partition_spec() == tuple(jax_spec.partition_spec())
    assert specs.TensorSpec(shape=(3,)).partition_spec() == ()

  def test_batch_dims_shift_the_annotation(self):
    jax_spec, port_spec = self._pair(sharding=(None, "model"))
    assert port_spec.with_batch(8).sharding == jax_spec.with_batch(
        8).sharding
    assert port_spec.with_batch(8).without_batch() == port_spec

  def test_partition_specs_and_sharding_axes(self):
    def structure(module):
      return module.SpecStruct({
          "a": module.TensorSpec(shape=(4,), dtype=np.float32),
          "b": module.TensorSpec(shape=(4, 6), dtype=np.float32,
                                 sharding=(None, "model"))})

    want = jax_specs.partition_specs(structure(jax_specs))
    got = specs.partition_specs(structure(specs))
    assert {k: tuple(v) for k, v in want.items()} == dict(got.items())
    assert dict(specs.sharding_axes(structure(specs))) == dict(
        jax_specs.sharding_axes(structure(jax_specs)))
