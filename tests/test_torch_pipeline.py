"""Pipeline parallelism in the port against the JAX package, on the CPU.

`parallel/pipeline_parallel.py`, `models/pipelined_model.py`,
`layers/vision.py` `PipelinedBerkeleyTower` and the pipelined BC-Z and
Grasp2Vec networks. Mirrors tests/test_moe_pipeline.py's
TestPipelineParallel, TestPipelinedModelTrainStep,
TestHeterogeneousPipeline, TestBCZPipelined, TestGrasp2VecPipelined,
TestScheduleAccounting, TestInterleavedPipeline,
TestPipelinedModelVirtualStages and TestVirtualStageSharpEdges.

Single-process cases (the sequential schedule, the accounting, the
layouts, the sharp edges) run here. The pipelined schedules run in ONE
8-rank gloo world (`test_torch_mesh_world`; cases in
`test_torch_pipeline_cases.pipeline_world`), started once and held in one
test function so that xdist starts it once, while this process computes
the JAX side on its 8 virtual devices, once, small.

Tolerances, of max(1, max |ref|): single-process float32 forward and
every gradient leaf 1e-5; mesh worlds 1e-4 (the mesh tests'); schedule
accounting, expert assignments and `pp/*` gauges exactly equal. The
gradients of a pipelined apply alone are those of the sum of every rank's
loss (the module docstring of `parallel.pipeline_parallel`): the world
returns them summed over the ranks and divided by the mesh size, which is
the global loss's gradient JAX returns.
"""

import functools
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensor2robot_tpu.models import pipelined_model as jax_pipelined_model
from tensor2robot_tpu.obs import metrics as jax_metrics
from tensor2robot_tpu.parallel import mesh as jax_mesh
from tensor2robot_tpu.parallel import pipeline_parallel as jax_pp
from tensor2robot_tpu.parallel import train_step as jax_ts
from tensor2robot_tpu.research.bcz import models as jax_bcz
from tensor2robot_tpu.research.grasp2vec import models as jax_g2v
from tensor2robot_tpu.specs import SpecStruct as JaxSpecStruct
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.layers import vision
from tensor2robot_tpu_torch.models import pipelined_model
from tensor2robot_tpu_torch.obs import metrics as obs_metrics
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import pipeline_parallel as pp
from tensor2robot_tpu_torch.parallel import train_step as ts
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.research.bcz import models as bcz_models
from tensor2robot_tpu_torch.research.grasp2vec import models as g2v_models
from tensor2robot_tpu_torch.specs import SpecStruct
from tests import test_torch_mesh_world as torch_mesh_world
from tests import test_torch_pipeline_cases as cases
from tests import torch_model_parity as parity

torch.set_num_threads(1)

F32_TOL = 1e-5
MESH_TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 6
PP_WIDTHS = dict(obs_size=8, action_size=3, hidden_size=16, num_stages=4,
                 num_microbatches=4)
BCZ_WIDTHS = dict(image_size=32, network="pipelined_berkeley",
                  num_waypoints=3, condition_mode="language",
                  condition_size=8, pipeline_microbatches=4)
G2V_WIDTHS = dict(image_size=32, tower="pipelined_conv",
                  filters=(16, 32, 32, 32), pipeline_microbatches=4)
MODEL_BATCH = 16
FAMILY_BATCH = 8
# The configs through train_eval_model in the world: 2 steps each, the
# image-model widths cut as tests/test_configs_smoke.py cuts them.
CONFIG_SHRINK = ("train_eval_model.max_train_steps = 2",
                 "train_eval_model.checkpoint_every_n_steps = 2",
                 "train_eval_model.log_every_n_steps = 1")
CONFIGS = {
    "train_pipelined_pp": CONFIG_SHRINK,
    "train_pipelined_1f1b": CONFIG_SHRINK,
    "train_bcz_pp": CONFIG_SHRINK + (
        "train_eval_model.eval_steps = 1",
        "train_eval_model.eval_every_n_steps = 2",
        "BCZModel.image_size = 32", "BCZModel.num_waypoints = 3",
        "BCZModel.use_bfloat16 = False",
        "BCZPreprocessor.input_size = (40, 40)",
        "BCZPreprocessor.crop_size = (36, 36)",
        "BCZPreprocessor.model_size = (32, 32)",
        "DefaultRandomInputGenerator.batch_size = 8"),
    "train_grasp2vec_pp": CONFIG_SHRINK + (
        "Grasp2VecModel.image_size = 32", "Grasp2VecModel.use_bfloat16 = False",
        "DefaultRandomInputGenerator.batch_size = 8"),
}


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _jax_stages(num_stages, dim=DIM, seed=0):
  keys = jax.random.split(jax.random.PRNGKey(seed), num_stages)
  return [{"w": jax.random.normal(k, (dim, dim)) / np.sqrt(dim),
           "b": jnp.zeros(dim)} for k in keys]


def _jax_stage_fn(params, x):
  return jnp.tanh(x @ params["w"] + params["b"])


def _hetero_setup():
  """JAX's TestHeterogeneousPipeline._setup."""
  key = jax.random.split(jax.random.PRNGKey(0), 8)
  p0 = {"w": jax.random.normal(key[0], (12, 20)) * 0.1, "b": jnp.zeros(20)}
  p1 = {"w": jax.random.normal(key[1], (20, 7)) * 0.1}
  p2 = {"w1": jax.random.normal(key[2], (7, 9)) * 0.1,
        "w2": jax.random.normal(key[3], (9, 5)) * 0.1}
  p3 = {"w": jax.random.normal(key[4], (5, 3)) * 0.1, "b": jnp.ones(3)}
  fns = [lambda p, x: jnp.tanh(x[:, :12] @ p["w"] + p["b"]),
         lambda p, x: jax.nn.relu(x[:, :20] @ p["w"]),
         lambda p, x: jnp.tanh(x[:, :7] @ p["w1"]) @ p["w2"],
         lambda p, x: x[:, :5] @ p["w"] + p["b"]]
  x = jax.random.normal(key[5], (4, 2, 12))
  micro = jnp.pad(x, ((0, 0), (0, 0), (0, 8)))
  return fns, [p0, p1, p2, p3], micro


def _hetero8_setup():
  key = jax.random.split(jax.random.PRNGKey(0), 9)
  dims = cases.HETERO8_DIMS
  params = [{"w": jax.random.normal(key[i], (dims[i], dims[i + 1])) * 0.2}
            for i in range(8)]
  fns = [lambda p, x, d=dims[i]: jnp.tanh(x[:, :d] @ p["w"])
         for i in range(8)]
  micro = jnp.pad(jax.random.normal(key[8], (8, 2, dims[0])),
                  ((0, 0), (0, 0), (0, max(dims) - dims[0])))
  return fns, params, micro


def _scaled(got, want):
  return parity.scaled_err(got, want)


def _close(got, want, tol, what=""):
  err = _scaled(got, want)
  assert err <= tol, (what, err)


def _port(params):
  return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
          params.items()}


def _mesh_like(shape):
  """A stand-in for a mesh where only its shape is read."""
  return types.SimpleNamespace(shape=dict(shape))


# -- schedule accounting (pure Python) ----------------------------------------


class TestScheduleAccounting:

  @pytest.mark.parametrize("s, m, v", [(4, 8, 1), (4, 8, 2), (4, 5, 2),
                                       (4, 8, 4), (1, 3, 1), (8, 2, 1),
                                       (4, 3, 2), (2, 7, 3)])
  def test_accounting_matches_jax(self, s, m, v):
    assert pp.schedule_accounting(s, m, v) == jax_pp.schedule_accounting(
        s, m, v)

  @pytest.mark.parametrize("s, m, v", [(4, 8, 1), (4, 5, 2), (4, 3, 2),
                                       (4, 8, 4), (2, 1, 1)])
  def test_tick_plan_matches_jax(self, s, m, v):
    total, out_ticks, plan = pp._tick_plan(s, m, v)
    jax_total, jax_out, jax_plan = jax_pp._tick_plan(s, m, v)
    assert total == jax_total
    assert out_ticks == [int(t) for t in np.asarray(jax_out)]
    for t in range(total):
      for idx in range(s):
        want = tuple(int(np.asarray(x)) for x in jax_plan(t, idx))
        assert tuple(int(x) for x in plan(t, idx)) == want, (t, idx)

  def test_interleave_order_and_stack(self):
    for s, v in ((4, 2), (4, 1), (2, 3)):
      assert pp.interleave_order(s, v).tolist() == \
          jax_pp.interleave_order(s, v).tolist()
    inter = pp.interleave_stage_stack(torch.arange(8.0), 4, 2)
    assert inter.tolist() == [0.0, 4.0, 1.0, 5.0, 2.0, 6.0, 3.0, 7.0]

  def test_validation(self):
    for args in ((0, 8, 1), (4, 0, 1), (4, 8, 0)):
      with pytest.raises(ValueError, match="num_stages"):
        pp.schedule_accounting(*args)

  @pytest.mark.parametrize("s, m, v", [(4, 2, 1), (4, 8, 2), (4, 4, 1)])
  def test_gauges_match_jax(self, s, m, v):
    with obs_metrics.isolated():
      pp._validate_and_account(s, m, v, "data")
      got = obs_metrics.snapshot(prefix="pp/")
    with jax_metrics.isolated():
      jax_pp._validate_and_account(s, m, v, "data")
      want = jax_metrics.snapshot(prefix="pp/")
    assert got == want

  def test_schedule_code_imports_no_jax(self):
    code = ("import sys\n"
            "from tensor2robot_tpu_torch.parallel import pipeline_parallel "
            "as pp\n"
            "acc = pp.schedule_accounting(4, 8, 2)\n"
            "assert acc['total_ticks'] == 19\n"
            "assert pp.interleave_order(4, 2).tolist() == "
            "[0, 4, 1, 5, 2, 6, 3, 7]\n"
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules)\n"
            "print('NO_JAX_OK')\n")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                            env={**os.environ, "PYTHONPATH": REPO},
                            capture_output=True, text=True, timeout=300)
    assert "NO_JAX_OK" in result.stdout, result.stderr[-2000:]


# -- the heterogeneous layout and the sequential schedule -------------------------


class TestHeterogeneousPipeline:

  def test_param_stack_matches_jax_ravel(self):
    _, params, _ = _hetero_setup()
    want, _, want_sizes = jax_pp.ravel_stage_stack(params)
    got, unravels, sizes = pp.ravel_stage_stack(
        [_port(p) for p in _np(params)])
    assert sizes == want_sizes == [260, 140, 108, 18]
    assert tuple(got.shape) == (4, 260)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = unravels[2](got[2, :sizes[2]])
    np.testing.assert_array_equal(back["w2"].numpy(),
                                  np.asarray(params[2]["w2"]))

  def test_sequential_forward_and_gradient_match_jax(self):
    fns, params, micro = _hetero_setup()
    stacked, unravels, sizes = jax_pp.ravel_stage_stack(params)

    def loss(sp):
      out = jax_pp.sequential_apply_heterogeneous(fns, unravels, sizes, sp,
                                                  micro)
      return jnp.mean(out[..., :3] ** 2), out

    (_, want), want_grad = jax.value_and_grad(loss, has_aux=True)(stacked)
    port_stacked, port_unravels, _ = pp.ravel_stage_stack(
        [_port(p) for p in _np(params)])
    port_stacked.requires_grad_(True)
    got = pp.sequential_apply_heterogeneous(
        cases.HETERO_FNS, port_unravels, sizes, port_stacked,
        torch.from_numpy(np.asarray(micro)))
    (got[..., :3] ** 2).mean().backward()
    _close(got, want, F32_TOL, "forward")
    _close(port_stacked.grad, want_grad, F32_TOL, "gradient")


# -- the pipelined model, single process --------------------------------------------


def _pp_batch(jax_model, batch=MODEL_BATCH):
  from tensor2robot_tpu import specs as jax_specs

  features = jax_specs.make_random_numpy(
      jax_model.get_feature_specification("train"), batch_size=batch, seed=0)
  labels = jax_specs.make_random_numpy(
      jax_model.get_label_specification("train"), batch_size=batch, seed=1)
  return ({k: np.asarray(v) for k, v in features.items()},
          {k: np.asarray(v) for k, v in labels.items()})


def _pp_models(**kwargs):
  widths = {**PP_WIDTHS, **kwargs}
  return (jax_pipelined_model.PipelinedRegressionModel(device_type="cpu",
                                                       **widths),
          pipelined_model.PipelinedRegressionModel(**widths))


def _train_parity(jax_model, model, features, labels):
  variables = parity.init_variables(jax_model, features)
  want = parity.jax_train(jax_model, variables, features, labels,
                          jnp.float32)
  params = bridge.state_dict_from_flax(variables["params"])
  assert set(params) == set(dict(model.module.named_parameters()))
  got = parity.port_train(model, params, {}, features, labels,
                          torch.float32)
  parity.compare_train(got, want, F32_TOL, F32_TOL)
  return variables, params


class TestPipelinedModelTrainStep:

  def test_sequential_step_matches_jax(self):
    jax_model, model = _pp_models()
    _train_parity(jax_model, model, *_pp_batch(jax_model))

  def test_fresh_parameters_have_flax_s_names_and_shapes(self):
    jax_model, model = _pp_models()
    features, _ = _pp_batch(jax_model)
    want = bridge.state_dict_from_flax(
        parity.init_variables(jax_model, features)["params"])
    got = model.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}

  def test_set_mesh_rejects_stage_mismatch(self):
    _, model = _pp_models(num_stages=3)
    with pytest.raises(ValueError, match="must match"):
      model.set_mesh(_mesh_like({"data": 2, "pp": 4, "model": 1}))

  def test_indivisible_microbatch_raises(self):
    _, model = _pp_models(num_microbatches=5)
    model.set_mesh(_mesh_like({"data": 2, "pp": 4, "model": 1}))
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="microbatches"):
      model.inference_network_fn(params, {}, {"observation": torch.zeros(
          16, 8)}, "train")

  def test_rules_match_jax(self):
    assert pipelined_model.pipeline_parallel_rules() == \
        jax_pipelined_model.pipeline_parallel_rules()
    params = pipelined_model.PipelinedRegressionModel(**PP_WIDTHS)\
        .init_params(torch.Generator().manual_seed(0))
    mesh = _mesh_like({"data": 2, "pp": 4, "model": 1})
    specs = {k: tuple(ts._leaf_partition(
        f"params/{k}", tuple(v.shape),
        pipelined_model.pipeline_parallel_rules(), mesh))
             for k, v in params.items()}
    assert specs == {"embed.weight": (), "embed.bias": (), "head.weight": (),
                     "head.bias": (), "stages_w1": ("pp", None, None),
                     "stages_w2": ("pp", None, None),
                     "stages_b1": ("pp", None), "stages_b2": ("pp", None)}


class TestPipelinedModelVirtualStages:

  def test_sequential_1f1b_step_matches_jax(self):
    """The interleaved checkpoint layout read back in depth order."""
    jax_model, model = _pp_models(num_stages=8, num_virtual_stages=2,
                                  num_microbatches=8)
    _train_parity(jax_model, model, *_pp_batch(jax_model))

  def test_set_mesh_rejects_chunk_mismatch(self):
    _, model = _pp_models(num_stages=6, num_virtual_stages=2)
    with pytest.raises(ValueError, match="virtual"):
      model.set_mesh(_mesh_like({"data": 2, "pp": 4, "model": 1}))


class TestVirtualStageSharpEdges:

  def test_model_rejects_indivisible_virtual_stages(self):
    for kwargs in (dict(num_stages=6, num_virtual_stages=4),
                   dict(num_stages=4, num_virtual_stages=0)):
      with pytest.raises(ValueError, match="multiple"):
        pipelined_model.PipelinedRegressionModel(**kwargs)

  def test_shard_pipeline_tree_places_any_stage_multiple(self):
    mesh = types.SimpleNamespace(group=lambda axis: mesh_lib.AxisGroup(
        axes=("pp",), ranks=(0, 1, 2, 3), index=2))
    tree = {"v2_stack": torch.arange(24.0).reshape(8, 3),
            "v1_stack": torch.zeros(4, 3), "count": 7,
            "scalar": torch.zeros(()), "odd": torch.zeros(6, 3)}
    placed = pp.shard_pipeline_tree(tree, mesh, "pp")
    assert placed["v2_stack"].tolist() == tree["v2_stack"][4:6].tolist()
    assert tuple(placed["v1_stack"].shape) == (1, 3)
    assert placed["count"] == 7 and placed["scalar"].shape == ()
    assert tuple(placed["odd"].shape) == (6, 3)

  def test_train_step_audit_waits_for_item_15_3(self, tmp_path):
    """`audit_name` wraps the step in an `XrayedFunction` under that
    name, as the JAX package's does; `cache` alone X-rays it too, and the
    X-ray's mesh gate keeps a step of more than one rank eager."""
    from tensor2robot_tpu_torch.obs import metrics as metrics_lib
    from tensor2robot_tpu_torch.obs import xray

    mesh = types.SimpleNamespace(group=lambda axes: None, axis_names=(),
                                 size=2)
    audited = pp.make_pipelined_train_step(None, None, None, mesh,
                                           audit_name="pp/step")
    assert isinstance(audited, xray.XrayedFunction)
    assert audited._name == "pp/step" and audited._mesh is mesh
    assert audited._donate_argnums == (0, 1)
    step = pp.make_pipelined_train_step(None, None, None, mesh,
                                        cache=str(tmp_path))
    assert isinstance(step, xray.XrayedFunction)
    with metrics_lib.isolated():
      gated = xray.XrayedFunction("pp/step", lambda x: x + 1,
                                  cache=str(tmp_path), mesh=mesh)
      assert gated(torch.ones(2)).tolist() == [2.0, 2.0]
      assert not gated.compiled
      assert metrics_lib.snapshot()["counter/cache/skipped_mesh"] == 1
    assert os.listdir(tmp_path) == []


# -- the pipelined research towers, single process --------------------------------


def _bcz_batch(seed, batch=FAMILY_BATCH):
  rng = np.random.RandomState(seed)
  features = {"image": rng.rand(batch, 32, 32, 3).astype(np.float32),
              "condition_embedding": rng.randn(batch, 8).astype(np.float32)}
  labels = {name: rng.randn(batch, 3, size).astype(np.float32)
            for name, size, _, _ in bcz_models.normalize_components(
                bcz_models.POSE_COMPONENTS)}
  labels["stop"] = (rng.rand(batch, 3) > 0.7).astype(np.float32)
  return features, labels


def _g2v_batch(seed, batch=FAMILY_BATCH):
  rng = np.random.RandomState(seed)
  features = {k: rng.randint(0, 256, (batch, 32, 32, 3)).astype(np.uint8)
              for k in ("pregrasp_image", "postgrasp_image", "goal_image")}
  return features, {}


def _float_images(features):
  return {k: v.astype(np.float32) / (255.0 if v.dtype == np.uint8 else 1.0)
          for k, v in features.items()}


def _assert_bf16(model, params, features, labels):
  """Every tower-sized product of one bf16 train step in bf16
  (tests/test_mixed_precision.py's bar)."""
  seen = cases.heavy_product_dtypes(lambda: ts.loss_and_grads(
      model, params, parity.port_inputs(features, torch.float32),
      parity.port_inputs(labels, torch.float32)))
  leaks, any_bf16 = cases.bf16_leaks(seen)
  assert any_bf16 and not leaks, seen


class TestBCZPipelined:

  def _models(self, **kwargs):
    kw = {**BCZ_WIDTHS, **kwargs}
    return (jax_bcz.BCZModel(device_type="cpu", **kw),
            bcz_models.BCZModel(**kw))

  def test_sequential_step_matches_jax(self):
    jax_model, model = self._models()
    _, params = _train_parity(jax_model, model, *_bcz_batch(0))
    assert tuple(params["tower.pp_stages"].shape) == (4, 19072)

  def test_fresh_parameters_have_flax_s_names_and_shapes(self):
    jax_model, model = self._models()
    want = bridge.state_dict_from_flax(
        parity.init_variables(jax_model, _bcz_batch(0)[0])["params"])
    got = model.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}

  def test_bfloat16_forward_and_compute_dtype(self):
    """The bf16 eval forward within max(1e-2, 4x JAX's bf16 distance from
    its f32 forward), and every conv and matmul of the bf16 train step
    in bf16 (the raveled f32 stack is cast inside the stages)."""
    jax_model, _ = self._models()
    jax16, model16 = self._models(use_bfloat16=True)
    features, labels = _bcz_batch(1)
    variables = parity.init_variables(jax_model, features)
    f32, _ = jax_model.inference_network_fn(variables, JaxSpecStruct(
        features), "eval")
    bf16, _ = jax16.inference_network_fn(variables, JaxSpecStruct(features),
                                         "eval")
    params = bridge.state_dict_from_flax(variables["params"])
    got, _ = model16.inference_network_fn(
        params, {}, model16.cast_features_for_compute(
            parity.port_inputs(features, torch.float32)), "eval")
    for key in ("xyz", "gripper"):
      limit = max(1e-2, 4.0 * _scaled(bf16[key], f32[key]))
      _close(got[key], f32[key], limit, key)
    _assert_bf16(model16, params, features, labels)

  def test_set_mesh_rejects_stage_mismatch(self):
    _, model = self._models()
    with pytest.raises(ValueError, match="must match"):
      model.set_mesh(_mesh_like({"data": 1, "pp": 8, "model": 1}))


class TestGrasp2VecPipelined:

  def _models(self, **kwargs):
    kw = {**G2V_WIDTHS, **kwargs}
    return (jax_g2v.Grasp2VecModel(device_type="cpu", **kw),
            g2v_models.Grasp2VecModel(**kw))

  def test_sequential_step_matches_jax(self):
    jax_model, model = self._models()
    features, _ = _g2v_batch(0)
    variables = parity.init_variables(jax_model, _float_images(features))
    want = parity.jax_train(jax_model, variables, features, {}, jnp.float32)
    params = bridge.state_dict_from_flax(variables["params"])
    assert {k for k in params if "pp_stages" in k} == {
        "scene.tower.pp_stages", "goal.tower.pp_stages"}
    got = parity.port_train(model, params, {}, features, {}, torch.float32)
    parity.compare_train(got, want, F32_TOL, F32_TOL)

  def test_bfloat16_compute_dtype(self):
    jax_model, model16 = self._models(use_bfloat16=True)
    features, _ = _g2v_batch(1)
    params = bridge.state_dict_from_flax(parity.init_variables(
        jax_model, _float_images(features))["params"])
    _assert_bf16(model16, params, features, {})

  def test_set_mesh_rejects_stage_mismatch(self):
    _, model = self._models()
    with pytest.raises(ValueError, match="must match"):
      model.set_mesh(_mesh_like({"data": 1, "pp": 8, "model": 1}))


def test_tower_matches_berkeley_net_semantics():
  """The stage function is BerkeleyNet's layer-norm conv block: the
  same weights through `vision.BerkeleyNet` (no spatial softmax) give
  the same NHWC map."""
  tower = vision.PipelinedBerkeleyTower((16, 16, 3), filters=(8, 4),
                                        kernel_sizes=(3, 3), strides=(2, 1))
  net = vision.BerkeleyNet(3, filters=(8, 4), kernel_sizes=(3, 3),
                           strides=(2, 1), use_spatial_softmax=False,
                           flatten=False)
  stacked = tower.initial_params(torch.Generator().manual_seed(0))
  stacked["pp_stages"][:, :].add_(0.0)
  stages = [tower.unravels[i](stacked["pp_stages"][i, :tower.sizes[i]])
            for i in range(2)]
  params = {}
  for i, stage in enumerate(stages):
    params[f"conv_{i}.weight"] = stage["kernel"].permute(3, 2, 0, 1)
    params[f"norm_{i}.weight"] = stage["ln_scale"] + 0.1 * i
    params[f"norm_{i}.bias"] = stage["ln_bias"] + 0.05
    stage["ln_scale"].add_(0.1 * i)
    stage["ln_bias"].add_(0.05)
  images = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
  got, _ = torch.func.functional_call(tower, stacked, (images,))
  want, _ = torch.func.functional_call(net, params, (images,))
  _close(got, want, F32_TOL)


# -- the pipelined schedules on an 8-rank gloo world ----------------------------------


def _payload(tmp_path):
  stacks = {v: _np(jax_pp.stack_stage_params(_jax_stages(4 * v)))
            for v in (1, 2, 4)}
  micro = {m: np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                           (m, 4, DIM)))
           for m in (3, 4, 5, 8)}
  _, hetero_params, hetero_micro = _hetero_setup()
  _, hetero8_params, hetero8_micro = _hetero8_setup()
  payload = {"stacks": stacks, "micro": micro,
             "hetero_params": _np(hetero_params),
             "hetero_micro": np.asarray(hetero_micro),
             "hetero8_params": _np(hetero8_params),
             "hetero8_micro": np.asarray(hetero8_micro),
             "step_x": np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                                    (4, 3, DIM))),
             "step_y": np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                    (4, 3, DIM))),
             "pp_widths": PP_WIDTHS, "bcz_widths": BCZ_WIDTHS,
             "grasp2vec_widths": G2V_WIDTHS,
             "configs": CONFIGS, "config_dir": str(tmp_path / "configs")}
  for name, kwargs in (("gpipe", {}), ("onefonb", dict(
      num_stages=8, num_virtual_stages=2, num_microbatches=8))):
    jax_model, _ = _pp_models(**kwargs)
    features, labels = _pp_batch(jax_model)
    variables = parity.init_variables(jax_model, features)
    payload[f"model_{name}"] = {
        "params": {k: v.numpy() for k, v in bridge.state_dict_from_flax(
            variables["params"]).items()},
        "features": features, "labels": labels, "variables": variables}
  for name, (jax_model, features, labels, images) in {
      "bcz": (jax_bcz.BCZModel(device_type="cpu", **BCZ_WIDTHS),
              *_bcz_batch(2), None),
      "grasp2vec": (jax_g2v.Grasp2VecModel(device_type="cpu", **G2V_WIDTHS),
                    *_g2v_batch(3), True)}.items():
    variables = parity.init_variables(
        jax_model, _float_images(features) if images else features)
    payload[f"model_{name}"] = {
        "params": {k: v.numpy() for k, v in bridge.state_dict_from_flax(
            variables["params"]).items()},
        "features": features, "labels": labels, "variables": variables}
  return payload


def _jax_side(payload):
  """Every reference of the world's cases, computed here once."""
  mesh = jax_mesh.create_mesh(mesh_shape=(2, 4, 1),
                              axis_names=("data", "pp", "model"))
  out = {}
  for num_micro, v, batch_axis in cases.APPLY_CASES:
    stacked = jax.tree_util.tree_map(jnp.asarray, payload["stacks"][v])
    micro = jnp.asarray(payload["micro"][num_micro])
    out[f"apply_{num_micro}_{v}_{batch_axis}"] = np.asarray(jax.jit(
        lambda p, x, b=batch_axis, v=v: jax_pp.pipelined_apply(
            _jax_stage_fn, p, x, mesh, "pp", batch_axis=b,
            num_virtual_stages=v))(stacked, micro))
  for num_micro, v, batch_axis in cases.GRAD_CASES:
    stacked = jax.tree_util.tree_map(jnp.asarray, payload["stacks"][v])
    micro = jnp.asarray(payload["micro"][num_micro])
    out[f"grad_{num_micro}_{v}_{batch_axis}"] = _np(jax.jit(jax.grad(
        lambda p, b=batch_axis, v=v, x=micro: jnp.mean(
            jax_pp.pipelined_apply(_jax_stage_fn, p, x, mesh, "pp",
                                   batch_axis=b, num_virtual_stages=v)
            ** 2)))(stacked))
  for name, setup, v, width in (("hetero", _hetero_setup, 1, 3),
                                ("hetero8", _hetero8_setup, 2, 4)):
    fns, params, micro = setup()
    stacked, unravels, sizes = jax_pp.ravel_stage_stack(params)

    def loss(sp, fns=fns, unravels=unravels, sizes=sizes, micro=micro, v=v,
             width=width):
      y = jax_pp.pipelined_apply_heterogeneous(
          fns, unravels, sizes, sp, micro, mesh, batch_axis="data",
          num_virtual_stages=v)
      return jnp.mean(y[..., :width] ** 2), y

    (_, y), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
    out[f"{name}_out"], out[f"{name}_grad"] = np.asarray(y), np.asarray(grad)
    out[f"{name}_stacked"] = np.asarray(stacked)
  for name, (s, m, v) in (("degenerate_snapshot", (4, 2, 1)),
                          ("onefonb_snapshot", (4, 8, 2))):
    with jax_metrics.isolated():
      jax_pp._validate_and_account(s, m, v, None)
      out[name] = jax_metrics.snapshot(prefix="pp/")
  # make_pipelined_train_step: one SGD step of the JAX step.
  stacked = jax.tree_util.tree_map(jnp.asarray, payload["stacks"][1])
  optimizer = optax.sgd(cases.PP_LR)
  step = jax_pp.make_pipelined_train_step(
      _jax_stage_fn, lambda y, t: ((y - t) ** 2).mean(), optimizer, mesh,
      donate=False)
  params, _, loss = step(jax_pp.shard_pipeline_tree(stacked, mesh),
                         jax_pp.shard_pipeline_tree(optimizer.init(stacked),
                                                    mesh),
                         jnp.asarray(payload["step_x"]),
                         jnp.asarray(payload["step_y"]))
  out["step_sgd_params"], out["step_sgd_loss"] = _np(params), float(loss)
  # The models: the global batch's loss and gradients, and one SGD step
  # of the JAX mesh step on the (2, 4, 1) mesh from the same weights.
  models = {
      "gpipe": lambda **kw: jax_pipelined_model.PipelinedRegressionModel(
          device_type="cpu", **PP_WIDTHS, **kw),
      "onefonb": lambda **kw: jax_pipelined_model.PipelinedRegressionModel(
          device_type="cpu", **{**PP_WIDTHS, **dict(
              num_stages=8, num_virtual_stages=2, num_microbatches=8)},
          **kw),
      "bcz": lambda **kw: jax_bcz.BCZModel(device_type="cpu", **BCZ_WIDTHS,
                                           **kw),
      "grasp2vec": lambda **kw: jax_g2v.Grasp2VecModel(
          device_type="cpu", **G2V_WIDTHS, **kw)}
  for name, model_fn in models.items():
    case = payload[f"model_{name}"]
    loss, _, _, grads, _ = parity.jax_train(
        model_fn(), case["variables"], case["features"], case["labels"],
        jnp.float32)
    jax_model = model_fn(optimizer_fn=lambda: optax.sgd(cases.PP_LR))
    jax_model.set_mesh(mesh)
    state, shardings = jax_ts.create_train_state(
        jax_model, jax.random.PRNGKey(0),
        _float_images(case["features"]) if name == "grasp2vec"
        else case["features"], mesh=mesh,
        rules=jax_pipelined_model.pipeline_parallel_rules())
    state = state.replace(params=jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, case["variables"]["params"]),
        shardings.params))
    new, metrics = jax_ts.make_train_step(
        jax_model, mesh=mesh, shardings=shardings, donate=False)(
            state, jax_mesh.put_host_batch(mesh, case["features"]),
            jax_mesh.put_host_batch(mesh, case["labels"]))
    out[f"model_{name}"] = {
        "loss": float(loss), "grads": grads,
        "step_loss": float(metrics["loss"]),
        "params": {k: v.numpy() for k, v in bridge.state_dict_from_flax(
            _np(jax.device_get(new.params))).items()}}
  return out


def _check_apply(port, want):
  for num_micro, v, batch_axis in cases.APPLY_CASES:
    key = f"apply_{num_micro}_{v}_{batch_axis}"
    _close(port[key], want[key], MESH_TOL, key)
  _close(port["apply_interleaved_layout"], want["apply_8_2_None"], MESH_TOL,
         "interleaved layout")
  for num_micro, v, batch_axis in cases.GRAD_CASES:
    key = f"grad_{num_micro}_{v}_{batch_axis}"
    for leaf in ("w", "b"):
      _close(port[key][leaf], want[key][leaf], MESH_TOL, (key, leaf))


def _check_hetero(port, want):
  np.testing.assert_array_equal(port["hetero_stacked"],
                                want["hetero_stacked"])
  assert port["hetero_sizes"] == [260, 140, 108, 18]
  for name in ("hetero", "hetero8"):
    _close(port[f"{name}_out"], want[f"{name}_out"], MESH_TOL, name)
    _close(port[f"{name}_grad"], want[f"{name}_grad"], MESH_TOL, name)
  assert "stage functions" in port["hetero_mismatch"]
  assert "stage functions" in port["hetero_v2_mismatch"]
  assert "leading dim" in port["hetero_wrong_stack"]
  assert "leading dim" in port["homogeneous_leading_dim"]
  assert "num_micro" in port["num_micro_zero"]
  assert port["degenerate_snapshot"] == want["degenerate_snapshot"]
  assert port["degenerate_snapshot"][
      "counter/pp/degenerate_microbatching"] == 1.0
  assert port["onefonb_snapshot"] == want["onefonb_snapshot"]
  # One staged hop a tick, forward and backward: 2 x 19 ticks.
  assert port["staged_hops"] == 2 * 19
  for leaf in ("w", "b"):
    _close(port["staged_grad"][leaf], want["grad_8_2_None"][leaf], MESH_TOL,
           leaf)


def _check_steps(port, want):
  assert port["step_sgd_block_rows"] == 1
  assert port["step_sgd_losses"][0] == pytest.approx(want["step_sgd_loss"],
                                                     rel=MESH_TOL)
  for leaf in ("w", "b"):
    _close(port["step_sgd_params"][leaf], want["step_sgd_params"][leaf],
           MESH_TOL, leaf)
  losses = port["step_adam_losses"]
  assert losses[-1] < 0.5 * losses[0], losses
  assert "partition rules must shard" in port["whole_stage_rules"]
  for name in ("gpipe", "onefonb", "bcz", "grasp2vec"):
    got, ref = port[f"model_{name}"], want[f"model_{name}"]
    assert got["loss"] == pytest.approx(ref["loss"], rel=MESH_TOL), name
    assert set(got["grads"]) == set(ref["grads"])
    for k, g in ref["grads"].items():
      scale = max(1.0, float(np.abs(parity.np64(g)).max()))
      err = float(np.abs(got["grads"][k] - parity.np64(g)).max()) / scale
      assert err <= MESH_TOL, (name, k, err)
    for k, p in ref["params"].items():
      _close(got["params"][k], p, MESH_TOL, (name, k))
    stage_leaves = {k: spec for k, spec in got["sharded"].items()}
    assert stage_leaves, name
    for k, (spec, local_shape) in stage_leaves.items():
      assert spec[0] == "pp", (name, k, spec)
      full = got["params"][k].shape
      assert local_shape[0] * 4 == full[0], (name, k, local_shape, full)
  for name in ("gpipe", "onefonb", "bcz", "grasp2vec"):
    # JAX's mesh step computes the global batch's loss.
    assert want[f"model_{name}"]["step_loss"] == pytest.approx(
        want[f"model_{name}"]["loss"], rel=F32_TOL), name
  for name in ("gpipe", "onefonb"):
    losses = port[f"model_{name}_adam"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def _check_configs(port, config_dir):
  for name in CONFIGS:
    result = port["configs"][name]
    assert np.isfinite(result["loss"]), (name, result)
    assert result["steps"] == [2], (name, result)
  assert np.isfinite(port["configs"]["train_bcz_pp"]["eval_loss"])
  # The BC-Z checkpoint served by one process: the sequential schedule,
  # each predict bit-identical to the eval-mode forward.
  model = bcz_models.BCZModel(
      network="pipelined_berkeley", condition_size=32, image_size=32,
      num_waypoints=3, preprocessor_cls=functools.partial(
          bcz_models.BCZPreprocessor, input_size=(40, 40), crop_size=(36, 36),
          model_size=(32, 32)))
  predictor = predictors.CheckpointPredictor(
      model=model, model_dir=os.path.join(config_dir, "train_bcz_pp"),
      device="cpu")
  assert predictor.restore() and predictor.global_step == 2
  rng = np.random.RandomState(17)
  features = {"image": rng.randint(0, 256, (2, 40, 40, 3)).astype(np.uint8),
              "condition_embedding": rng.randn(2, 32).astype(np.float32)}
  served = predictor.predict(features)
  prepared, _ = model.preprocessor.preprocess(
      SpecStruct({k: torch.from_numpy(v) for k, v in features.items()}),
      None, "predict")
  with torch.no_grad():
    forward, _ = model.inference_network_fn(
        predictor.state.eval_params(), predictor.state.mutable_state,
        prepared, "predict")
  assert served["xyz"].shape == (2, 3, 3)
  np.testing.assert_array_equal(served["xyz"], forward["xyz"].float().numpy())


def test_pipeline_world_matches_jax(tmp_path):
  """Every world-backed case (one world, started once): the schedules
  (GPipe and 1F1B, homogeneous and heterogeneous, with and without the
  data split) forward and backward, the validation and the `pp/*`
  gauges, the staged transport's hop count, `make_pipelined_train_step`,
  the ZeRO-3 step of the pipelined model (both schedules), BC-Z and
  Grasp2Vec on the (2, 4, 1) mesh, and the four pipelined configs
  through `train_eval_model`, the BC-Z checkpoint then served."""
  payload = _payload(tmp_path)
  world = torch_mesh_world.World(
      8, "tests.test_torch_pipeline_cases:pipeline_world",
      {k: v for k, v in payload.items() if not k.startswith("model_")}
      | {k: {kk: vv for kk, vv in v.items() if kk != "variables"}
         for k, v in payload.items() if k.startswith("model_")},
      tmp_path / "world", timeout=600)
  want = _jax_side(payload)
  port = world.results()[0]
  _check_apply(port, want)
  _check_hetero(port, want)
  _check_steps(port, want)
  _check_configs(port, payload["config_dir"])
