"""Mixture of experts in the port against the JAX package, on the CPU.

`layers/moe.py` (dense, sparse and all-to-all dispatch, the float32
router, the bf16 expert einsums) and `models/moe_model.py`. Mirrors
tests/test_moe_pipeline.py's TestMoE, TestSparseDispatch, TestMoEAllToAll
and TestExpertParallelTrainStep, and the MoE cases of
tests/test_mixed_precision.py and tests/test_configs_smoke.py.

Single-process cases run here. The mesh cases run in ONE 4-rank gloo
world (`test_torch_mesh_world`; cases in `test_torch_moe_cases.moe_world`),
started once and held in one test function so that xdist starts it once;
the JAX side runs here, once, on 4 of the 8 virtual devices (the same
mesh shapes: the JAX package's own tests run the all-to-all on 4 and 8
devices and the expert-parallel step on (2, 1, 4)).

Expert assignments are held equal exactly before any value is compared
(top-k ties go to the lower index in both packages). Tolerances, of
max(1, max |ref|): single process 1e-5, forward and every gradient leaf;
mesh worlds 1e-4. Router noise is injected: JAX's threefry draw and
torch's are not the same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensor2robot_tpu.layers import moe as jax_moe
from tensor2robot_tpu.models import moe_model as jax_moe_model
from tensor2robot_tpu.parallel import mesh as jax_mesh
from tensor2robot_tpu.parallel import train_step as jax_ts
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.layers import moe
from tensor2robot_tpu_torch.models import moe_model
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.predictors import predictors
from tests import test_torch_mesh_world as torch_mesh_world
from tests import test_torch_moe_cases as cases
from tests import test_torch_pipeline_cases as pipeline_cases
from tests import torch_model_parity as parity

torch.set_num_threads(1)

F32_TOL = 1e-5
MESH_TOL = 1e-4
TOKENS = 32
MODEL_WIDTHS = dict(obs_size=8, action_size=3, hidden_size=16)
MODEL_BATCH = 32
GLOBAL_CASES = {
    "dense_top2": dict(num_experts=4, hidden_size=8, output_size=6, top_k=2,
                       dispatch="dense"),
    "sparse": dict(num_experts=4, hidden_size=8, output_size=6,
                   dispatch="sparse"),
    "sparse_top2": dict(num_experts=4, hidden_size=8, output_size=6, top_k=2,
                        dispatch="sparse"),
}
CONFIG_SHRINK = ("train_eval_model.max_train_steps = 2",
                 "train_eval_model.checkpoint_every_n_steps = 2",
                 "train_eval_model.log_every_n_steps = 1")
CONFIGS = {"sparse": CONFIG_SHRINK,
           "alltoall": CONFIG_SHRINK + (
               "MoERegressionModel.dispatch = 'alltoall'",
               "expert_parallel_rules.axis = 'data'")}


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _port(params):
  return {k: v.clone() for k, v in bridge.state_dict_from_flax(
      _np(params)).items()}


def _jax_layer(**kwargs):
  return jax_moe.MixtureOfExperts(**kwargs)


def _layer(**kwargs):
  kwargs.pop("mesh", None)
  return moe.MixtureOfExperts(5, **kwargs)


def _tokens(n=16, seed=0):
  return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n, 5)))


def _test_loss(out, aux):
  return (out ** 2).mean() + 0.01 * aux


def _jax_case(module, variables, x):
  """(out, aux, top-k indices, grads by the port's names) of JAX's
  layer."""

  def loss(params):
    out, aux = module.apply({"params": params}, x)
    return _test_loss(out, aux), (out, aux)

  (_, (out, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
      variables["params"])
  kernel = variables["params"]["router"]["kernel"]
  probs = jax.nn.softmax(x @ kernel + variables["params"]["router"]["bias"])
  _, top_idx = jax.lax.top_k(probs, module.top_k)
  return (np.asarray(out), float(aux), np.asarray(top_idx),
          bridge.state_dict_from_flax(_np(grads)))


def _port_case(layer, params, x, train=False):
  leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
  x = torch.from_numpy(np.array(x))
  out, aux = torch.func.functional_call(layer, leaves, (x,),
                                        {"train": train})
  grads = torch.autograd.grad(_test_loss(out, aux), list(leaves.values()))
  with torch.no_grad():
    _, _, top_idx = torch.func.functional_call(
        cases._Route(layer), {f"layer.{k}": v for k, v in leaves.items()},
        (x,))
  return (out.detach(), float(aux.detach()), top_idx.numpy(),
          dict(zip(leaves, grads)))


def _compare(got, want, tol=F32_TOL):
  out, aux, top_idx, grads = got
  w_out, w_aux, w_idx, w_grads = want
  np.testing.assert_array_equal(top_idx, w_idx)
  assert parity.scaled_err(out, w_out) <= tol
  assert abs(aux - w_aux) <= tol * max(1.0, abs(w_aux))
  assert set(grads) == set(w_grads)
  for k, g in w_grads.items():
    assert parity.scaled_err(grads[k], g) <= tol, k


def _parity(jax_kwargs, x=None, variables_from=None, train=False):
  x = _tokens() if x is None else x
  module = _jax_layer(**jax_kwargs)
  variables = (variables_from or module).init(jax.random.PRNGKey(1),
                                              jnp.asarray(x))
  want = _jax_case(module, variables, jnp.asarray(x))
  got = _port_case(_layer(**jax_kwargs), _port(variables["params"]), x,
                   train)
  _compare(got, want)
  return got, want, variables


class TestMoE:

  def test_shapes_and_aux_loss(self):
    (out, aux, _, _), _, _ = _parity(dict(num_experts=4, hidden_size=8,
                                          output_size=6))
    assert tuple(out.shape) == (16, 6)
    assert aux >= 1.0 - 1e-3  # the Switch auxiliary's floor at balance

  def test_top2_gates_mix_experts(self):
    (out, _, top_idx, _), _, _ = _parity(dict(num_experts=4, hidden_size=8,
                                              output_size=6, top_k=2))
    assert tuple(out.shape) == (16, 6) and top_idx.shape == (16, 2)

  def test_gradients_flow_to_all_router_and_experts(self):
    (_, _, _, grads), _, _ = _parity(dict(num_experts=4, hidden_size=8,
                                          output_size=6))
    assert float(grads["router.weight"].abs().max()) > 0
    assert float(grads["experts_w1"].abs().max()) > 0

  def test_leading_dims_and_fresh_parameters(self):
    module = _jax_layer(num_experts=4, hidden_size=8, output_size=6)
    x = jnp.asarray(_tokens().reshape(4, 4, 5))
    variables = module.init(jax.random.PRNGKey(1), x)
    want, _ = module.apply(variables, x)
    layer = _layer(num_experts=4, hidden_size=8, output_size=6)
    got, _ = torch.func.functional_call(
        layer, _port(variables["params"]), (torch.from_numpy(np.array(x)),))
    assert parity.scaled_err(got, want) <= F32_TOL
    fresh = {k: tuple(v.shape) for k, v in
             moe_model.MoERegressionModel(**MODEL_WIDTHS).init_params(
                 torch.Generator().manual_seed(0)).items()}
    jax_model = jax_moe_model.MoERegressionModel(device_type="cpu",
                                                 **MODEL_WIDTHS)
    variables = parity.init_variables(jax_model, _model_batch(jax_model)[0])
    assert fresh == {k: tuple(v.shape) for k, v in bridge.state_dict_from_flax(
        variables["params"]).items()}

  def test_router_noise_injected(self, monkeypatch):
    """The JAX layer's noise draw injected into the port's layer."""
    kwargs = dict(num_experts=4, hidden_size=8, output_size=6,
                  router_noise=0.5)
    module = _jax_layer(**kwargs)
    x = jnp.asarray(_tokens())
    variables = module.init(jax.random.PRNGKey(1), x)
    draws = []
    real = jax.random.normal

    def recording(key, shape=(), *args, **kw):
      value = real(key, shape, *args, **kw)
      draws.append(np.asarray(value))
      return value

    monkeypatch.setattr(jax.random, "normal", recording)
    want, _ = module.apply(variables, x, train=True,
                           rngs={"dropout": jax.random.PRNGKey(3)})
    layer = _layer(**kwargs)
    layer.noise_fn = lambda shape, dtype, device: torch.from_numpy(
        np.array(draws[-1])).to(dtype)
    got, _ = torch.func.functional_call(
        layer, _port(variables["params"]), (torch.from_numpy(np.array(x)),),
        {"train": True})
    assert parity.scaled_err(got, want) <= F32_TOL
    plain, _ = module.apply(variables, x)
    assert parity.scaled_err(plain, want) > F32_TOL  # the noise mattered

  def test_rules_match_jax(self):
    assert moe.expert_axis_param_rule("data") == \
        jax_moe.expert_axis_param_rule("data")
    assert moe.EXPERT_AXIS_PARAM_RULE == jax_moe.EXPERT_AXIS_PARAM_RULE
    for axis in ("model", "data"):
      assert moe_model.expert_parallel_rules(axis=axis) == \
          jax_moe_model.expert_parallel_rules(axis=axis)


class TestSparseDispatch:

  @pytest.mark.parametrize("top_k", [1, 2])
  def test_matches_dense_when_capacity_ample(self, top_k):
    kw = dict(num_experts=4, hidden_size=8, output_size=6, top_k=top_k)
    x = _tokens(12 if top_k == 2 else 16)
    dense_got, _, variables = _parity(dict(dispatch="dense", **kw), x=x)
    sparse_got, _, _ = _parity(dict(dispatch="sparse", capacity_factor=16.0,
                                    **kw), x=x,
                               variables_from=_jax_layer(dispatch="dense",
                                                         **kw))
    assert parity.scaled_err(sparse_got[0], dense_got[0]) <= F32_TOL

  @pytest.mark.parametrize("top_k, capacity_factor", [(1, 1.25), (2, 1.0),
                                                      (2, 0.5)])
  def test_drops_match_jax(self, top_k, capacity_factor):
    _parity(dict(num_experts=4, hidden_size=8, output_size=6, top_k=top_k,
                 dispatch="sparse", capacity_factor=capacity_factor),
            x=_tokens(24, seed=4))

  def test_tight_capacity_drops_overflow_tokens(self):
    kwargs = dict(num_experts=2, hidden_size=4, output_size=3,
                  dispatch="sparse", capacity_factor=1e-9)
    (out, _, _, _), _, _ = _parity(kwargs, x=np.ones((6, 5), np.float32))
    assert int((out.abs().sum(-1) > 1e-9).sum()) == 1

  def test_sparse_flops_scale_with_capacity_not_tokens(self):
    layer = _layer(num_experts=4, hidden_size=8, output_size=6,
                   dispatch="sparse", capacity_factor=1.0)
    params = layer.initial_params(torch.Generator().manual_seed(0))
    params.update({"router.weight": torch.randn(4, 5),
                   "router.bias": torch.zeros(4)})
    shapes = set()
    from torch.utils._python_dispatch import TorchDispatchMode

    class Shapes(TorchDispatchMode):

      def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor):
          shapes.add(tuple(out.shape))
        return out

    with Shapes():
      torch.func.functional_call(layer, params, (torch.randn(64, 5),))
    assert (4, 16, 5) in shapes or (4 * 16, 5) in shapes, sorted(shapes)
    assert (4, 64, 8) not in shapes, sorted(shapes)

  @pytest.mark.parametrize("dispatch", ["dense", "sparse"])
  def test_trunk_bfloat16_products(self, dispatch):
    """tests/test_mixed_precision.py's MoE bar: the expert products in
    bf16, the router and the gates float32 by design (small)."""
    model = moe_model.MoERegressionModel(
        obs_size=64, action_size=8, num_experts=4, hidden_size=128,
        dispatch=dispatch, use_bfloat16=True)
    params = model.init_params(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    features = {"observation": torch.from_numpy(
        rng.randn(16, 64).astype(np.float32))}
    labels = {"action": torch.from_numpy(rng.randn(16, 8).astype(
        np.float32))}
    seen = pipeline_cases.heavy_product_dtypes(lambda: ts.loss_and_grads(
        model, params, model.cast_features_for_compute(features), labels))
    leaks, any_bf16 = pipeline_cases.bf16_leaks(seen)
    assert any_bf16 and not leaks, seen


class TestMoEAllToAll:

  def test_requires_mesh(self):
    layer = moe.MixtureOfExperts(5, num_experts=8, dispatch="alltoall")
    with pytest.raises(ValueError, match="mesh"):
      layer(torch.zeros(8, 5))
    with pytest.raises(ValueError, match="set_mesh"):
      moe_model.MoERegressionModel(dispatch="alltoall").create_module()


def _model_batch(jax_model, batch=MODEL_BATCH):
  from tensor2robot_tpu import specs as jax_specs

  features = jax_specs.make_random_numpy(
      jax_model.get_feature_specification("train"), batch_size=batch, seed=0)
  labels = jax_specs.make_random_numpy(
      jax_model.get_label_specification("train"), batch_size=batch, seed=1)
  return ({k: np.asarray(v) for k, v in features.items()},
          {k: np.asarray(v) for k, v in labels.items()})


class TestExpertParallelTrainStep:

  @pytest.mark.parametrize("dispatch", ["sparse", "dense"])
  def test_single_process_step_matches_jax(self, dispatch):
    jax_model = jax_moe_model.MoERegressionModel(
        device_type="cpu", dispatch=dispatch, **MODEL_WIDTHS)
    model = moe_model.MoERegressionModel(dispatch=dispatch, **MODEL_WIDTHS)
    features, labels = _model_batch(jax_model)
    variables = parity.init_variables(jax_model, features)
    want = parity.jax_train(jax_model, variables, features, labels,
                            jnp.float32)
    got = parity.port_train(model, bridge.state_dict_from_flax(
        variables["params"]), {}, features, labels, torch.float32)
    parity.compare_train(got, want, F32_TOL, F32_TOL)


# -- the 4-rank world ----------------------------------------------------------------


def _payload(tmp_path):
  kw = dict(cases.A2A_KW)
  x = _tokens(TOKENS)
  a2a = _jax_layer(dispatch="dense", **kw).init(jax.random.PRNGKey(1),
                                                jnp.asarray(x))
  global_variables = _jax_layer(**GLOBAL_CASES["sparse"]).init(
      jax.random.PRNGKey(2), jnp.asarray(x))
  payload = {"tokens": x, "a2a_variables": a2a,
             "a2a_params": {k: v.numpy() for k, v in
                            _port(a2a["params"]).items()},
             "global_variables": global_variables,
             "global_params": {k: v.numpy() for k, v in
                               _port(global_variables["params"]).items()},
             "global_cases": GLOBAL_CASES, "configs": CONFIGS,
             "config_dir": str(tmp_path / "configs")}
  for name, kwargs in (("ep", dict(num_experts=4, dispatch="sparse")),
                       ("a2a", dict(num_experts=8, dispatch="alltoall",
                                    capacity_factor=2.0))):
    jax_model = jax_moe_model.MoERegressionModel(
        device_type="cpu", **MODEL_WIDTHS, **kwargs)
    features, labels = _model_batch(jax_model)
    if kwargs["dispatch"] == "alltoall":
      jax_model.set_mesh(jax.sharding.Mesh(
          np.array(jax.devices()[:4]).reshape(4, 1, 1),
          ("data", "fsdp", "model")))
    variables = parity.init_variables(jax_model, features)
    payload[f"model_{name}"] = {
        "params": {k: v.numpy() for k, v in bridge.state_dict_from_flax(
            variables["params"]).items()},
        "features": features, "labels": labels, "variables": variables}
  return payload


def _jax_side(payload):
  out = {}
  devices = np.array(jax.devices()[:4])
  mesh4 = jax.sharding.Mesh(devices.reshape(4, 1, 1), ("data", "fsdp",
                                                       "model"))
  x = jnp.asarray(payload["tokens"])
  a2a = _jax_layer(dispatch="alltoall", mesh=mesh4, ep_axis="data",
                   capacity_factor=64.0, **cases.A2A_KW)
  dense = _jax_layer(dispatch="dense", **cases.A2A_KW)
  out["a2a"] = _jax_case(a2a, payload["a2a_variables"], x)
  out["a2a_dense"] = _jax_case(dense, payload["a2a_variables"], x)
  pinned = jax.tree_util.tree_map(jnp.asarray, payload["a2a_variables"])
  pinned = {"params": {**pinned["params"], "router": {
      "kernel": jnp.zeros_like(pinned["params"]["router"]["kernel"]),
      "bias": jnp.zeros((8,)).at[0].set(10.0)}}}
  kw = dict(num_experts=8, hidden_size=8, output_size=6, top_k=1,
            capacity_factor=1.0)
  for name, module in (
      ("pinned_a2a", _jax_layer(dispatch="alltoall", mesh=mesh4,
                                ep_axis="data", **kw)),
      ("pinned_sparse", _jax_layer(dispatch="sparse", **kw))):
    out[name] = np.asarray(jax.jit(lambda v, x, m=module: m.apply(v, x)[0])(
        pinned, x))
  for name, kwargs in GLOBAL_CASES.items():
    out[f"global_{name}"] = _jax_case(_jax_layer(**kwargs),
                                      payload["global_variables"], x)
  # The models: the global batch's gradients and one SGD mesh step.
  for name, shape, kwargs, axis in (
      ("ep", (2, 1, 2), dict(num_experts=4, dispatch="sparse"), "model"),
      ("a2a", (4, 1, 1), dict(num_experts=8, dispatch="alltoall",
                              capacity_factor=2.0), "data")):
    case = payload[f"model_{name}"]
    mesh = jax.sharding.Mesh(devices.reshape(shape), ("data", "fsdp",
                                                      "model"))
    jax_model = jax_moe_model.MoERegressionModel(
        device_type="cpu", optimizer_fn=lambda: optax.sgd(cases.LR),
        **MODEL_WIDTHS, **kwargs)
    jax_model.set_mesh(mesh)
    loss, _, scalars, grads, _ = parity.jax_train(
        jax_model, case["variables"], case["features"], case["labels"],
        jnp.float32)
    state, shardings = jax_ts.create_train_state(
        jax_model, jax.random.PRNGKey(0), case["features"], mesh=mesh,
        rules=jax_moe_model.expert_parallel_rules(axis=axis))
    state = state.replace(params=jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, case["variables"]["params"]),
        shardings.params))
    new, metrics = jax_ts.make_train_step(
        jax_model, mesh=mesh, shardings=shardings, donate=False)(
            state, jax_mesh.put_host_batch(mesh, case["features"]),
            jax_mesh.put_host_batch(mesh, case["labels"]))
    out[f"model_{name}"] = {
        "loss": float(loss), "step_loss": float(metrics["loss"]),
        "aux": float(scalars["moe_aux_loss"]), "grads": grads,
        "params": {k: v.numpy() for k, v in bridge.state_dict_from_flax(
            _np(jax.device_get(new.params))).items()}}
  return out


def _check_layers(port, want):
  for name in ["a2a"] + [f"global_{n}" for n in GLOBAL_CASES]:
    got, ref = port[name], want[name]
    np.testing.assert_array_equal(got["top_idx"], ref[2])
    assert parity.scaled_err(got["out"], ref[0]) <= MESH_TOL, name
    assert abs(got["aux"] - ref[1]) <= MESH_TOL * max(1.0, abs(ref[1])), name
    for k, g in ref[3].items():
      assert parity.scaled_err(got["grads"][k], g) <= MESH_TOL, (name, k)
  # Nothing drops at capacity factor 64: the all-to-all is the dense layer.
  assert parity.scaled_err(port["a2a"]["out"], want["a2a_dense"][0]) \
      <= MESH_TOL
  for name in ("pinned_a2a", "pinned_sparse"):
    assert parity.scaled_err(port[name], want[name]) <= MESH_TOL, name
  kept = lambda out: set(np.nonzero(np.abs(out).sum(-1) > 1e-9)[0].tolist())
  assert kept(port["pinned_a2a"]) == {0, 8, 16, 24}
  assert kept(port["pinned_sparse"]) == {0, 1, 2, 3}
  assert "divisible" in port["indivisible"]


def _check_models(port, want):
  for name, axis, local_experts in (("ep", "model", 2), ("a2a", "data", 2)):
    got, ref = port[f"model_{name}"], want[f"model_{name}"]
    assert got["loss"] == pytest.approx(ref["loss"], rel=MESH_TOL), name
    assert ref["step_loss"] == pytest.approx(ref["loss"], rel=F32_TOL)
    assert set(got["grads"]) == set(ref["grads"])
    for k, g in ref["grads"].items():
      assert parity.scaled_err(got["grads"][k], g) <= MESH_TOL, (name, k)
    for k, p in ref["params"].items():
      assert parity.scaled_err(got["params"][k], p) <= MESH_TOL, (name, k)
    experts = {k: v for k, v in got["sharded"].items() if "experts_" in k}
    assert len(experts) == 4 and set(got["sharded"]) == set(experts), got
    for spec, local in experts.values():
      assert spec == (axis, None, None) and local[0] == local_experts
    losses = got["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
  leaks, any_bf16 = pipeline_cases.bf16_leaks(port["a2a_bf16"])
  assert any_bf16 and not leaks, port["a2a_bf16"]


def _check_configs(port, config_dir):
  for name in CONFIGS:
    result = port["configs"][name]
    assert np.isfinite(result["loss"]) and result["steps"] == [2], result
  # The sparse checkpoint served by one process (no mesh: the layer runs
  # its experts whole), each predict bit-identical to the eval forward.
  model = moe_model.MoERegressionModel(obs_size=16, action_size=7,
                                       num_experts=4, hidden_size=32)
  predictor = predictors.CheckpointPredictor(
      model=model, model_dir=f"{config_dir}/sparse", device="cpu")
  assert predictor.restore() and predictor.global_step == 2
  features = {"observation": np.random.RandomState(3).randn(5, 16).astype(
      np.float32)}
  served = predictor.predict(features)
  with torch.no_grad():
    forward, _ = model.inference_network_fn(
        predictor.state.eval_params(), predictor.state.mutable_state,
        {"observation": torch.from_numpy(features["observation"])},
        "predict")
  np.testing.assert_array_equal(served["action"], forward["action"].numpy())


def test_moe_world_matches_jax(tmp_path):
  """Every world-backed case (one world, started once): the all-to-all
  layer (forward, assignments, every gradient) against JAX's on the
  same 4-way mesh and against the dense layer, the per-source-shard
  capacity beside sparse dispatch's global one, dense and sparse layers
  over a data-split batch (global capacity and statistics), the
  expert-parallel step on (2, 1, 2) and the all-to-all step on (4, 1, 1)
  against JAX's mesh steps, the bf16 all-to-all trunk's products, and
  `train_moe_ep.gin` (sparse, and all-to-all over the data axis) through
  `train_eval_model`, the sparse checkpoint then served."""
  payload = _payload(tmp_path)
  world = torch_mesh_world.World(
      4, "tests.test_torch_moe_cases:moe_world",
      {k: v for k, v in payload.items() if "variables" not in k}
      | {k: {kk: vv for kk, vv in v.items() if kk != "variables"}
         for k, v in payload.items() if k.startswith("model_")},
      tmp_path / "world", timeout=600)
  want = _jax_side(payload)
  port = world.results()[0]
  _check_layers(port, want)
  _check_models(port, want)
  _check_configs(port, payload["config_dir"])
