"""The port stands apart from the JAX package and from the CPU.

* No file of `tensor2robot_tpu_torch/` (nor `chip_smoke.py`) imports
  jax, flax, optax, orbax, absl or tensor2robot_tpu (AST scan), and every
  module imports with those blocked. No port module and no native source
  of the port names a path under `tensor2robot_tpu/`: the port keeps its
  own copy of what it needs, C++ sources included, and reads nothing of
  the JAX package.
* Entry points raise without a CUDA device unless asked for the CPU.
* `chip_smoke.py` exits non-zero and prints no result where there is no
  CUDA device, and in a directory that holds nothing else of the repo.
* The port's session and training configs parse and bind the
  long-context widths, and its QT-Opt config the flagship critic's.
* A kernel library's name changes with any `csrc/*.cuh` header, and
  `profile_train` finds both designs of each flash kernel by name and
  sorts the critic's device kernels by kind.
* `chip_smoke.py` labels mangled kernel names by their length prefixes,
  digits inside a name included, and bounds f32 work by 3xTF32 where
  that is faster than the f32 CUDA cores.
"""

import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.serving import session
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import device as device_lib

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO_ROOT / "tensor2robot_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "absl",
             "tensor2robot_tpu")


def _port_files():
  return sorted(PORT.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]


def _port_modules():
  return sorted(
      ".".join(p.relative_to(REPO_ROOT).with_suffix("").parts).removesuffix(
          ".__init__")
      for p in PORT.rglob("*.py"))


def test_no_port_file_imports_jax_or_the_jax_package():
  offenders = []
  for path in _port_files():
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
      if isinstance(node, ast.Import):
        names = [alias.name for alias in node.names]
      elif isinstance(node, ast.ImportFrom) and node.level == 0:
        names = [node.module or ""]
      else:
        continue
      for name in names:
        if name.split(".")[0] in FORBIDDEN:
          offenders.append(f"{path.relative_to(REPO_ROOT)}:{node.lineno} "
                           f"imports {name}")
  assert not offenders, offenders
  assert len(_port_files()) > 20


def test_the_scans_cover_the_telemetry_modules():
  """The import scans above and below walk every module of the port; the
  telemetry slice's modules are among them."""
  telemetry = ["obs/faultlab.py", "obs/flightrec.py", "obs/runlog.py",
               "obs/sentinel.py", "obs/stepstats.py", "obs/xray.py",
               "utils/backend.py", "bin/graftscope.py"]
  files = set(_port_files())
  modules = set(_port_modules())
  for rel in telemetry:
    assert PORT / rel in files, rel
    assert "tensor2robot_tpu_torch." + rel[:-3].replace("/", ".") in modules


def test_the_scans_cover_the_analysis_modules():
  """The import scans walk the static-analysis subpackage and its CLI:
  none of its modules imports jax or the JAX package, and each imports
  with them blocked."""
  analysis = sorted((PORT / "analysis").glob("*.py"))
  assert len(analysis) >= 18
  files = set(_port_files())
  modules = set(_port_modules())
  for path in analysis + [PORT / "bin" / "graftlint.py"]:
    assert path in files, path
    module = ".".join(path.relative_to(REPO_ROOT).with_suffix("").parts)
    assert module.removesuffix(".__init__") in modules
  for name in ("graph_audit", "tracer_check", "config_check", "engine",
               "lint"):
    assert PORT / "analysis" / f"{name}.py" in files


def test_no_port_module_names_a_path_in_the_jax_package():
  offenders = []
  for path in sorted(PORT.rglob("*.py")):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
      if isinstance(node, ast.Constant) and isinstance(node.value, str) \
          and "tensor2robot_tpu/" in node.value:
        offenders.append(f"{path.relative_to(REPO_ROOT)}:{node.lineno}")
  native_sources = sorted((PORT / "native").glob("*.[ch]*"))
  assert len(native_sources) == 5
  for path in native_sources:
    for lineno, line in enumerate(path.read_text().splitlines(), 1):
      if "tensor2robot_tpu/" in line:
        offenders.append(f"{path.relative_to(REPO_ROOT)}:{lineno}")
  assert not offenders, offenders


def test_every_port_module_imports_with_jax_blocked():
  code = (
      "import importlib, sys\n"
      f"for name in {FORBIDDEN!r}:\n"
      "  sys.modules[name] = None\n"
      f"for module in {_port_modules()!r}:\n"
      "  importlib.import_module(module)\n"
      "print('imported', len(sys.modules))\n")
  result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
  assert result.returncode == 0, result.stderr
  assert "imported" in result.stdout


@pytest.fixture
def no_cuda(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
  model = sequence_model.SequenceRegressionModel(
      obs_size=4, action_size=2, sequence_length=8, hidden_size=32,
      num_heads=4)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    device_lib.resolve_device()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    device_lib.resolve_device("cuda")
  with pytest.raises(RuntimeError, match="no CUDA device"):
    predictors.CheckpointPredictor(model=model)
  predictor = predictors.CheckpointPredictor(model=model, device="cpu")
  predictor.init_randomly()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    session.SessionEngine(predictor=predictor)
  engine = session.SessionEngine(predictor=predictor, device="cpu")
  sid = engine.open()
  out = engine.step(sid, {"observation": np.zeros(4, np.float32)})
  assert out["action"].shape == (2,)


def _run_chip_smoke(cwd):
  env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
  return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                        capture_output=True, text=True, timeout=120)


def _prints_a_result(stdout):
  for line in stdout.splitlines():
    try:
      if "ok" in json.loads(line):
        return True
    except (ValueError, TypeError):
      continue
  return False


def test_chip_smoke_fails_without_a_card():
  result = _run_chip_smoke(REPO_ROOT)
  assert result.returncode != 0
  assert not _prints_a_result(result.stdout)


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
  shutil.copy(REPO_ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
  result = _run_chip_smoke(tmp_path)
  assert result.returncode != 0
  assert not _prints_a_result(result.stdout)


def test_session_config_binds_the_long_context_widths():
  try:
    config.parse_config_file(
        str(PORT / "configs" / "serve_session.gin"))
    model = sequence_model.SequenceRegressionModel()
    assert (model._obs_size, model._action_size, model.decode_max_ticks,
            model._hidden_size, model._num_blocks, model._num_heads,
            model.head_dim, model._attention_backend) == (
                16, 7, 4096, 512, 2, 8, 64, "flash")
    assert config.query_parameter("SessionEngine.max_sessions") == 64
    assert config.query_parameter("SessionEngine.max_tick_batch") == 8
    assert config.query_parameter("SessionEngine.admission") == "evict_lru"
  finally:
    config.clear_config()


def test_train_config_binds_the_long_context_widths():
  try:
    config.parse_config_file(
        str(PORT / "configs" / "train_longcontext_flash.gin"))
    model = config.query_parameter("train_eval_model.model")
    assert model is not None
    model = sequence_model.SequenceRegressionModel()
    assert (model._obs_size, model._action_size, model._sequence_length,
            model._hidden_size, model._num_blocks, model._num_heads,
            model.head_dim, model._attention_backend, model.use_bfloat16) == (
                16, 7, 4096, 512, 2, 8, 64, "flash", True)
    assert config.query_parameter("train_eval_model.mode") == "train"
    assert config.query_parameter("train_eval_model.max_train_steps") == 1000
    assert config.query_parameter(
        "train_eval_model.checkpoint_every_n_steps") == 500
    assert config.query_parameter(
        "DefaultRandomInputGenerator.batch_size") == 2
  finally:
    config.clear_config()


def test_qtopt_config_binds_the_flagship_widths():
  from tensor2robot_tpu_torch.research.qtopt import models as qtopt_models

  try:
    config.parse_config_file(str(PORT / "configs" / "train_qtopt.gin"))
    model = config.query_parameter("train_eval_model.model")
    assert model is not None
    model = qtopt_models.QTOptModel()
    assert (model.network, model._image_size, model._action_size,
            model._grasp_param_names, model.use_bfloat16, model.use_ema,
            model.ema_decay, model._l2_regularization) == (
                "grasping44", 472, 5,
                {"world_vector": (0, 3), "vertical_rotation": (3, 2)}, True,
                True, 0.9999, 7e-5)
    assert model.module.fc0.in_features == 8 * 8 * 64
    for name, value in (("mode", "train_and_evaluate"),
                        ("max_train_steps", 1000), ("eval_steps", 100),
                        ("eval_every_n_steps", 500),
                        ("checkpoint_every_n_steps", 500)):
      assert config.query_parameter(f"train_eval_model.{name}") == value
    assert config.query_parameter(
        "DefaultRandomInputGenerator.batch_size") == 32
    assert config.query_parameter(
        "train_eval_model.input_generator_eval") is not None
  finally:
    config.clear_config()


def test_tuned_config_binds_the_batch_256_critic():
  from tensor2robot_tpu_torch.research.qtopt import models as qtopt_models

  try:
    config.parse_config_file(str(PORT / "configs" / "train_qtopt_tuned.gin"))
    model = qtopt_models.QTOptModel()
    assert (model.network, model._image_size, model._action_size,
            model.use_bfloat16, model.use_ema, model.remat,
            model.module.space_to_depth) == (
                "grasping44", 472, 5, True, True, False, False)
    assert config.query_parameter(
        "DefaultRandomInputGenerator.batch_size") == 256
    for name, value in (("device_prefetch_depth", 2),
                        ("host_overlap_workers", 2),
                        ("host_overlap_queue_mb", 384),
                        ("mode", "train_and_evaluate")):
      assert config.query_parameter(f"train_eval_model.{name}") == value
    config.parse_config("QTOptModel.remat = True")
    config.parse_config("QTOptModel.space_to_depth = True")
    model = qtopt_models.QTOptModel()
    assert model.remat and model.module.space_to_depth
  finally:
    config.clear_config()


def test_records_config_binds_the_record_generators(tmp_path):
  from tensor2robot_tpu_torch.data import input_generators
  from tensor2robot_tpu_torch.research.qtopt import models as qtopt_models

  try:
    config.parse_config_file(str(PORT / "configs" /
                                 "train_qtopt_records.gin"))
    for scope, pattern in (("train", "t-*"), ("eval", "e-*")):
      config.parse_config(f"{scope}/DefaultRecordInputGenerator."
                          f"file_patterns = '{tmp_path / pattern}'")
    train = config.query_parameter("train_eval_model.input_generator_train")
    evaluation = config.query_parameter(
        "train_eval_model.input_generator_eval")
    assert isinstance(train, input_generators.DefaultRecordInputGenerator)
    assert isinstance(evaluation,
                      input_generators.DefaultRecordInputGenerator)
    assert (train._file_patterns, evaluation._file_patterns,
            train.batch_size) == (str(tmp_path / "t-*"),
                                  str(tmp_path / "e-*"), 32)
    model = qtopt_models.QTOptModel()
    assert (model.network, model._image_size, model.use_bfloat16) == (
        "grasping44", 472, True)
    assert config.query_parameter("train_eval_model.mode") == \
        "train_and_evaluate"
  finally:
    config.clear_config()


def test_trainer_raises_without_cuda(no_cuda, tmp_path):
  from tensor2robot_tpu_torch import train_eval
  from tensor2robot_tpu_torch.data import input_generators

  model = sequence_model.SequenceRegressionModel(
      obs_size=4, action_size=2, sequence_length=8, hidden_size=32,
      num_heads=4)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    train_eval.train_eval_model(
        model=model, model_dir=str(tmp_path), mode="train",
        input_generator_train=input_generators.DefaultRandomInputGenerator())
  with pytest.raises(RuntimeError, match="no CUDA device"):
    predictors.CheckpointPredictor(model=model, model_dir=str(tmp_path))


def test_library_path_follows_headers(monkeypatch, tmp_path):
  from tensor2robot_tpu_torch.ops import _kernels

  (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
  (tmp_path / "common.cuh").write_text("// v1\n")
  monkeypatch.setattr(_kernels, "CSRC_DIR", tmp_path)
  first = _kernels._library_path("k")
  assert _kernels._library_path("k") == first
  (tmp_path / "common.cuh").write_text("// v2\n")
  second = _kernels._library_path("k")
  assert second != first
  (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
  assert _kernels._library_path("k") not in (first, second)


def test_profile_train_matches_both_flash_designs():
  from tensor2robot_tpu_torch.bin import profile_train

  events = [
      ("void (anonymous namespace)::tc::flash_fwd_tc_kernel<64>(...)", 3.0),
      ("void (anonymous namespace)::tc::flash_fwd_tc_split_kernel<64>(...)",
       1.0),
      ("void (anonymous namespace)::tc::flash_bwd_dq_tc_kernel<64>(...)",
       4.0),
      ("void (anonymous namespace)::tc::flash_bwd_dkv_tc_kernel<64>(...)",
       2.0),
      ("ampere_bf16_s16816gemm", 5.0)]
  launched = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
  assert profile_train.flash_device_ms(events, launched) == {
      "flash_fwd": 4.0, "flash_bwd_dq": 4.0, "flash_bwd_dkv": 2.0}
  with pytest.raises(RuntimeError, match="flash_bwd_dkv"):
    profile_train.flash_device_ms(events[:3], launched)
  assert profile_train.flash_device_ms(
      events[:3], dict(launched, flash_bwd_dkv=0))["flash_bwd_dkv"] == 0


def test_profile_train_sorts_device_kernels_by_kind():
  from tensor2robot_tpu_torch.bin import profile_train

  events = [
      ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc", 4.0),
      ("sm90_xmma_wgrad_implicit_gemm_indexed_wo_smem", 3.0),
      ("cutlass3x_sm90_tensorop_s64x64x16gemm_bf16", 1.0),
      ("void at::native::(anonymous namespace)::max_pool_forward_nchw", 0.5),
      ("void at::native::reduce_kernel<512, 1, ReduceOp<float>>", 0.25),
      ("void at::native::vectorized_elementwise_kernel<4, AddFunctor>", 2.0),
      ("Memcpy HtoD (Pageable -> Device)", 0.125),
      ("flash_bwd_dq_tc_kernel<64>", 0.0625),
      ("some_new_kernel", 0.03125)]
  assert profile_train.device_ms_by_kind(events) == {
      "flash": 0.0625, "cudnn_conv": 7.0, "cublas_gemm": 1.0,
      "max_pool": 0.5, "reduction": 0.25, "elementwise": 2.0,
      "copy": 0.125, "other": 0.03125}


@pytest.mark.parametrize("line, label", [
    # A digit inside the kernel's name.
    ("        Function : _ZN12_GLOBAL__N_12tc23flash_fwd_tf32x3_kernelILi64EE"
     "Ev14CUtensorMap_stS2_S2_PfS3_iiif", "flash_fwd_tf32x3_kernel<64>"),
    # The CUDA-core dQ as it was templated on its dtype.
    ("Function : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelI13__nv_bfloat16Li64E"
     "EEvPKT_S4_S4_S4_PKfS6_PS2_iiif", "flash_bwd_dq_kernel<bf16,64>"),
    # A tensor-core kernel, as ptxas names it.
    ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_12tc22flash_"
     "bwd_dq_tc_kernelILi128EEEv14CUtensorMap_stS2_S2_S2_PKfS4_P13__nv_bfl"
     "oat16iiiiff' for 'sm_90a'", "flash_bwd_dq_tc_kernel<128>"),
    ("ptxas info    : Used 168 registers", None),
])
def test_chip_smoke_labels_mangled_kernel_names(line, label):
  import chip_smoke

  assert chip_smoke._kernel_label(line) == label


# (flops, dtype, bound ms, path) at the timed shapes: the f32 forward at
# B1 H8 T4096 D64 causal (one product pair, 4*B*H*T^2*D/2), the f32 dQ
# (3 products) and dK/dV (4) at B2, the bf16 dQ at B2.
_PRODUCT_B2 = 2 * 2 * 8 * 4096 * 4096 * 64 // 2


@pytest.mark.parametrize("flops, dtype, ms, path", [
    (4 * 8 * 4096 * 4096 * 64 // 2, "float32", 0.1041, "3xtf32 tensor cores"),
    (3 * _PRODUCT_B2, "float32", 0.3124, "3xtf32 tensor cores"),
    (4 * _PRODUCT_B2, "float32", 0.4165, "3xtf32 tensor cores"),
    (3 * _PRODUCT_B2, "bfloat16", 0.0521, "bfloat16 tensor cores"),
])
def test_chip_smoke_bounds_take_the_fastest_exact_path(flops, dtype, ms, path):
  import chip_smoke

  got = chip_smoke.bound(1e6, flops, dtype)
  assert got["bound_by"] == "operations" and got["bound_path"] == path
  assert got["bound_ms"] == pytest.approx(ms, abs=1e-4)
  memory = chip_smoke.bound(1e12, flops, dtype)
  assert memory["bound_by"] == "bytes"
  assert memory["bound_ms"] == pytest.approx(1e3 / 3.35, rel=1e-9)


def test_export_and_hooks_packages_import_no_jax():
  modules = ["tensor2robot_tpu_torch.export.export_generator",
             "tensor2robot_tpu_torch.hooks.core",
             "tensor2robot_tpu_torch.hooks.td3",
             "tensor2robot_tpu_torch.bin.export_saved_model"]
  assert set(modules) <= set(_port_modules())
  code = (
      "import importlib, sys\n"
      f"for name in {FORBIDDEN!r}:\n"
      "  sys.modules[name] = None\n"
      f"for module in {modules!r}:\n"
      "  importlib.import_module(module)\n"
      "print(sorted(m for m in sys.modules if sys.modules[m] is not None\n"
      f"             and m.split('.')[0] in {FORBIDDEN!r}))\n")
  result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
  assert result.returncode == 0, result.stderr
  assert result.stdout.strip() == "[]"


def test_export_config_binds_only_port_configurables():
  from tensor2robot_tpu_torch.export import export_generator
  from tensor2robot_tpu_torch.hooks import core as hooks_core

  try:
    config.parse_config_file(str(PORT / "configs" /
                                 "train_qtopt_export.gin"))
    registry = config._REGISTRY
    assert registry.imports and all(
        m.startswith("tensor2robot_tpu_torch.") for m in registry.imports)
    for _, name, _ in registry.bindings:
      configurable = config.get_configurable(name)
      module = getattr(configurable, "__module__", "")
      assert module.startswith("tensor2robot_tpu_torch."), (name, module)
    (builder,) = config.query_parameter("train_eval_model.hook_builders")
    assert isinstance(builder, hooks_core.AsyncExportHookBuilder)
    assert isinstance(builder._export_generator,
                      export_generator.DefaultExportGenerator)
    assert (builder._num_versions, builder._lagged,
            builder._async_export) == (3, True, True)
    assert config.query_parameter("QTOptModel.image_size") == 472
    assert config.query_parameter("train_eval_model.mode") == \
        "train_and_evaluate"
  finally:
    config.clear_config()


# The pose environment's robot loop and meta-learning: every module the
# scans above must cover.
SLICE_12_MODULES = (
    "tensor2robot_tpu_torch.layers.spatial_softmax",
    "tensor2robot_tpu_torch.layers.vision",
    "tensor2robot_tpu_torch.research.pose_env.models",
    "tensor2robot_tpu_torch.research.pose_env.meta_tasks",
    "tensor2robot_tpu_torch.envs.pose_env",
    "tensor2robot_tpu_torch.envs.run_env",
    "tensor2robot_tpu_torch.envs.run_meta_env",
    "tensor2robot_tpu_torch.obs.trace",
    "tensor2robot_tpu_torch.utils.mocks",
    "tensor2robot_tpu_torch.meta_learning.batch_utils",
    "tensor2robot_tpu_torch.meta_learning.maml",
    "tensor2robot_tpu_torch.meta_learning.preprocessors",
    "tensor2robot_tpu_torch.meta_learning.meta_example",
    "tensor2robot_tpu_torch.meta_learning.task_data",
    "tensor2robot_tpu_torch.meta_learning.meta_policies",
    "tensor2robot_tpu_torch.bin.run_collect_eval",
    "tensor2robot_tpu_torch.bin.run_meta_collect_eval",
    "tensor2robot_tpu_torch.bin.maml_end_task",
)


def test_the_scans_cover_the_pose_and_meta_modules():
  assert set(SLICE_12_MODULES) <= set(_port_modules())
  for name in ("train_pose_regression", "train_pose_mc_critic",
               "train_pose_maml", "collect_random", "mock_train"):
    text = (PORT / "configs" / f"{name}.gin").read_text()
    assert "import tensor2robot_tpu." not in text, name
    assert "device_type" not in text.split("\n\n", 1)[1], name


def _pose_maml():
  from tensor2robot_tpu_torch.meta_learning import maml
  from tensor2robot_tpu_torch.research.pose_env import models as pose_models

  return maml.MAMLModel(
      base_model=pose_models.PoseEnvRegressionModel(image_size=16),
      num_condition_samples_per_task=2, num_inference_samples_per_task=1)


def test_meta_policy_runs_on_cuda_unless_told_cpu(no_cuda):
  from tensor2robot_tpu_torch.meta_learning import meta_policies

  with pytest.raises(RuntimeError, match="no CUDA device"):
    predictors.CheckpointPredictor(model=_pose_maml())
  predictor = predictors.CheckpointPredictor(model=_pose_maml(),
                                             device="cpu")
  predictor.init_randomly()
  policy = meta_policies.MAMLRegressionPolicy(predictor=predictor)
  rng = np.random.RandomState(0)
  policy.adapt({"state/image": rng.randint(0, 256, (2, 16, 16, 1)).astype(
      np.uint8)}, {"target_pose": rng.rand(2, 2).astype(np.float32)})
  action = policy.select_action({"state/image": np.zeros((16, 16, 1),
                                                         np.uint8)})
  assert action.shape == (2,) and np.isfinite(action).all()


def test_run_collect_eval_runs_on_cuda_unless_told_cpu(no_cuda, tmp_path):
  from tensor2robot_tpu_torch.bin import run_collect_eval

  flags = ["--config_files", str(PORT / "configs" / "collect_random.gin"),
           "--config", f"collect_eval_loop.root_dir = '{tmp_path}'",
           "--config", "collect_eval_loop.policy = @CEMPolicy()",
           "--config", "CEMPolicy.action_size = 2",
           "--config", "CEMPolicy.predictor = @CheckpointPredictor()",
           "--config", "CheckpointPredictor.model = "
                       "@PoseEnvContinuousMCModel()",
           "--config", "collect_eval_loop.total_timeout_secs = 0.2",
           "--config", "collect_eval_loop.poll_interval_secs = 0.05",
           "--config", "import tensor2robot_tpu_torch.predictors.predictors",
           "--config", "import tensor2robot_tpu_torch.policies.policies",
           "--config",
           "import tensor2robot_tpu_torch.research.pose_env.models"]
  try:
    with pytest.raises(RuntimeError, match="no CUDA device"):
      run_collect_eval.main(flags)
    config.clear_config()
    # Told the CPU, it runs: no checkpoint yet, so it times out polling.
    stats = run_collect_eval.main(
        flags + ["--config", "CheckpointPredictor.device = 'cpu'"])
    assert stats == {}
  finally:
    config.clear_config()


# Grasp2Vec and BC-Z: every module the scans above must cover.
SLICE_13_MODULES = (
    "tensor2robot_tpu_torch.preprocessors.image_ops",
    "tensor2robot_tpu_torch.preprocessors.base",
    "tensor2robot_tpu_torch.layers.film_resnet",
    "tensor2robot_tpu_torch.layers.snail",
    "tensor2robot_tpu_torch.layers.bcz_networks",
    "tensor2robot_tpu_torch.layers.tec",
    "tensor2robot_tpu_torch.research.grasp2vec.losses",
    "tensor2robot_tpu_torch.research.grasp2vec.models",
    "tensor2robot_tpu_torch.research.grasp2vec.visualization",
    "tensor2robot_tpu_torch.research.bcz.models",
)


def test_the_scans_cover_the_grasp2vec_and_bcz_modules():
  assert set(SLICE_13_MODULES) <= set(_port_modules())


@pytest.mark.parametrize("name,widths", [
    ("train_bcz", {"BCZModel.image_size": 64, "BCZModel.num_waypoints": 10,
                   "BCZModel.network": "resnet_film",
                   "BCZModel.condition_size": 32,
                   "BCZModel.use_bfloat16": True,
                   "BCZPreprocessor.input_size": (96, 96),
                   "BCZPreprocessor.crop_size": (80, 80),
                   "BCZPreprocessor.model_size": (64, 64),
                   "DefaultRandomInputGenerator.batch_size": 16,
                   "train_eval_model.mode": "train_and_evaluate"}),
    ("train_grasp2vec", {"Grasp2VecModel.image_size": 48,
                         "Grasp2VecModel.loss_type": "npairs",
                         "DefaultRandomInputGenerator.batch_size": 16,
                         "train_eval_model.mode": "train"})])
def test_bcz_and_grasp2vec_configs_bind_only_port_configurables(name, widths):
  text = (PORT / "configs" / f"{name}.gin").read_text()
  assert "device_type" not in text.split("\n\n", 1)[1]
  try:
    config.parse_config_file(str(PORT / "configs" / f"{name}.gin"))
    registry = config._REGISTRY
    assert registry.imports and all(
        m.startswith("tensor2robot_tpu_torch.") for m in registry.imports)
    for _, binding, _ in registry.bindings:
      module = getattr(config.get_configurable(binding), "__module__", "")
      assert module.startswith("tensor2robot_tpu_torch."), (binding, module)
    for key, value in widths.items():
      assert config.query_parameter(key) == value, key
    model = config.query_parameter("train_eval_model.model")
    assert type(model).__module__.startswith("tensor2robot_tpu_torch.")
  finally:
    config.clear_config()


def test_bcz_and_grasp2vec_pipelined_variants_name_item_14():
  """Item 14 is ported: the pipelined variants build, and no port
  module raises naming it (the raises this test once pinned)."""
  from tensor2robot_tpu_torch.research.bcz import models as bcz_models
  from tensor2robot_tpu_torch.research.grasp2vec import models as g2v_models

  g2v_models.Grasp2VecModel(tower="pipelined_conv").create_module()
  bcz_models.BCZModel(network="pipelined_berkeley").create_module()
  for path in _port_files():
    assert not re.search(r"NotImplementedError\([^)]*item 14",
                         path.read_text(), re.S), path


# VRGripper and the last helpers: every module the scans above must cover.
SLICE_14_MODULES = (
    "tensor2robot_tpu_torch.layers.mdn",
    "tensor2robot_tpu_torch.research.vrgripper.maf",
    "tensor2robot_tpu_torch.research.vrgripper.models",
    "tensor2robot_tpu_torch.ops.rotations",
    "tensor2robot_tpu_torch.utils.subsample",
    "tensor2robot_tpu_torch.utils.test_fixture",
)


def test_the_scans_cover_the_vrgripper_and_helper_modules():
  assert set(SLICE_14_MODULES) <= set(_port_modules())


@pytest.mark.parametrize("name,widths", [
    ("train_vrgripper_mdn", {
        "VRGripperRegressionModel.episode_length": 8,
        "VRGripperRegressionModel.image_size": 48,
        "VRGripperRegressionModel.num_mixture_components": 5,
        "DefaultRandomInputGenerator.batch_size": 8}),
    ("train_vrgripper_da_maml", {
        "MAMLModel.num_inner_loop_steps": 1,
        "MAMLModel.inner_learning_rate": 0.01,
        "MAMLModel.num_condition_samples_per_task": 2,
        "MAMLModel.num_inference_samples_per_task": 2,
        "VRGripperDomainAdaptiveModel.episode_length": 8,
        "VRGripperDomainAdaptiveModel.image_size": 48,
        "DefaultRandomInputGenerator.batch_size": 2}),
    ("train_wtl_maml", {
        "MAMLModel.num_inner_loop_steps": 1,
        "MAMLModel.inner_learning_rate": 0.1,
        "MAMLModel.num_condition_samples_per_task": 2,
        "MAMLModel.num_inference_samples_per_task": 2,
        "DefaultRandomInputGenerator.batch_size": 4}),
    ("train_wtl_retrial", {
        "WTLStateTrialModel.retrial": True,
        "WTLStateTrialModel.obs_size": 32,
        "WTLStateTrialModel.action_size": 7,
        "WTLStateTrialModel.episode_length": 40,
        "WTLStateTrialModel.embed_type": "temporal",
        "DefaultRandomInputGenerator.batch_size": 4})])
def test_vrgripper_configs_bind_only_port_configurables(name, widths):
  text = (PORT / "configs" / f"{name}.gin").read_text()
  assert "device_type" not in "\n".join(
      line for line in text.splitlines() if not line.startswith("#"))
  try:
    config.parse_config_file(str(PORT / "configs" / f"{name}.gin"))
    registry = config._REGISTRY
    assert registry.imports and all(
        m.startswith("tensor2robot_tpu_torch.") for m in registry.imports)
    for _, binding, _ in registry.bindings:
      module = getattr(config.get_configurable(binding), "__module__", "")
      assert module.startswith("tensor2robot_tpu_torch."), (binding, module)
    for key, value in widths.items():
      assert config.query_parameter(key) == value, key
    assert config.query_parameter("train_eval_model.mode") == "train"
    model = config.query_parameter("train_eval_model.model")
    assert type(model).__module__.startswith("tensor2robot_tpu_torch.")
  finally:
    config.clear_config()


def test_maml_takes_a_base_with_inner_loop_forward_kwargs():
  from tensor2robot_tpu_torch.meta_learning import maml
  from tensor2robot_tpu_torch.research.vrgripper import models as vr

  base = vr.VRGripperDomainAdaptiveModel(episode_length=2, image_size=12,
                                         action_size=2)
  model = maml.MAMLModel(base_model=base, num_condition_samples_per_task=2,
                         num_inference_samples_per_task=2)
  rng = np.random.RandomState(0)
  features = {}
  for split in ("condition", "inference"):
    features[f"{split}/features/image"] = torch.from_numpy(
        rng.rand(1, 2, 2, 12, 12, 3)).float()
    features[f"{split}/features/gripper_pose"] = torch.from_numpy(
        rng.randn(1, 2, 2, 7)).float()
  features["condition/labels/action"] = torch.zeros(1, 2, 2, 2)
  outputs, _ = model.inference_network_fn(
      model.init_params(torch.Generator().manual_seed(0)), {}, features,
      "train")
  assert outputs["inner_losses"].shape == (1, 2)
  assert torch.isfinite(outputs["inner_losses"]).all()


def test_wtl_policy_and_vrgripper_predictor_run_on_cuda_unless_told_cpu(
    no_cuda):
  from tensor2robot_tpu_torch.research.vrgripper import models as vr

  model = vr.WTLStateTrialModel(obs_size=4, action_size=2, episode_length=3)
  with pytest.raises(RuntimeError):
    predictors.CheckpointPredictor(model=model, model_dir="/nonexistent")
  predictor = predictors.CheckpointPredictor(model=model, device="cpu")
  assert predictor.device.type == "cpu"


# The serving observability seams: framework-free modules (their twins in
# the JAX package import no jax either).
OBSERVABILITY_FILES = ("obs/graftrace.py", "obs/aggregate.py",
                       "obs/usage.py", "obs/slo.py", "bin/graftscope.py",
                       "serving/batcher.py")


@pytest.mark.parametrize("rel", OBSERVABILITY_FILES)
def test_observability_modules_import_neither_torch_nor_jax(rel):
  """AST scan: no import of torch or of a JAX module, at any depth."""
  path = PORT / rel
  names = []
  for node in ast.walk(ast.parse(path.read_text(), str(path))):
    if isinstance(node, ast.Import):
      names += [alias.name for alias in node.names]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      names.append(node.module or "")
  roots = {name.split(".")[0] for name in names}
  assert not roots & ({"torch", "triton"} | set(FORBIDDEN)), (rel, roots)
  assert path in set(_port_files())


def test_observability_modules_load_with_torch_and_jax_blocked():
  """Loaded by path in a process where torch and jax cannot be imported
  (the serving package's __init__ imports the engines, so the batcher is
  loaded by its file), the CLIs' timeline and watch run."""
  code = (
      "import importlib, importlib.util, os, sys, tempfile\n"
      "for name in ('torch', 'jax', 'tensor2robot_tpu'):\n"
      "  sys.modules[name] = None\n"
      "for name in ('graftrace', 'aggregate', 'usage', 'slo'):\n"
      "  importlib.import_module('tensor2robot_tpu_torch.obs.' + name)\n"
      "path = os.path.join('tensor2robot_tpu_torch', 'serving', "
      "'batcher.py')\n"
      "spec = importlib.util.spec_from_file_location('batcher', path)\n"
      "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
      "from tensor2robot_tpu_torch.bin import graftscope\n"
      "from tensor2robot_tpu_torch.obs import graftrace\n"
      "root = tempfile.mkdtemp()\n"
      "graftrace.configure(root)\n"
      "assert graftrace.flush() is not None\n"
      "assert graftscope.main(['timeline', root]) == 1\n"
      "assert graftscope.main(['watch', root, '--snapshot']) == 0\n"
      "print('OBSERVABILITY_FRAMEWORK_FREE_OK')\n")
  result = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
  assert result.returncode == 0, result.stderr[-3000:]
  assert "OBSERVABILITY_FRAMEWORK_FREE_OK" in result.stdout


# The mesh slice: every module the scans above (no jax, no
# tensor2robot_tpu; importable with both blocked) must cover.
SLICE_18_MODULES = (
    "tensor2robot_tpu_torch.parallel.collectives",
    "tensor2robot_tpu_torch.parallel.mesh",
    "tensor2robot_tpu_torch.parallel.train_step",
    "tensor2robot_tpu_torch.ops.attention",
    "tensor2robot_tpu_torch.layers.attention_layers",
    "tensor2robot_tpu_torch.checkpoints",
    "tensor2robot_tpu_torch.bin.run_t2r_trainer",
)


def test_the_scans_cover_the_mesh_modules():
  assert set(SLICE_18_MODULES) <= set(_port_modules())
  port_files = {str(p.relative_to(REPO_ROOT)) for p in _port_files()}
  assert "tensor2robot_tpu_torch/parallel/collectives.py" in port_files


def test_mesh_entry_points_run_on_cuda_unless_told_cpu(no_cuda):
  from tensor2robot_tpu_torch.parallel import mesh as mesh_lib

  with pytest.raises(RuntimeError, match="no CUDA device"):
    mesh_lib.create_mesh()
  assert mesh_lib.create_mesh(device="cpu").size == 1


def test_sp_ring_config_binds_the_jax_widths_and_mesh():
  try:
    config.clear_config()
    config.parse_config_file(str(PORT / "configs" / "train_sp_ring.gin"))
    assert config.query_parameter("train_eval_model.mesh_shape") == (2, 2, 1)
    assert config.query_parameter("train_eval_model.mesh_axis_names") == (
        "data", "sp", "model")
    assert config.query_parameter(
        "SequenceRegressionModel.attention_backend") == "ring"
    model = config.query_parameter("train_eval_model.model")
    assert type(model).__module__.startswith("tensor2robot_tpu_torch.")
  finally:
    config.clear_config()


# Pipeline parallelism and mixture of experts: every module the scans
# above must cover, and the five configs of the slice.
SLICE_19_MODULES = (
    "tensor2robot_tpu_torch.parallel.pipeline_parallel",
    "tensor2robot_tpu_torch.models.pipelined_model",
    "tensor2robot_tpu_torch.models.moe_model",
    "tensor2robot_tpu_torch.layers.moe",
    "tensor2robot_tpu_torch.layers.vision",
    "tensor2robot_tpu_torch.research.bcz.models",
    "tensor2robot_tpu_torch.research.grasp2vec.models",
)
SLICE_19_CONFIGS = {
    "train_pipelined_pp.gin": "tensor2robot_tpu/configs/train_pipelined_pp.gin",
    "train_pipelined_1f1b.gin":
        "tensor2robot_tpu/configs/train_pipelined_1f1b.gin",
    "train_moe_ep.gin": "tensor2robot_tpu/configs/train_moe_ep.gin",
    "train_bcz_pp.gin":
        "tensor2robot_tpu/research/bcz/configs/train_bcz_pp.gin",
    "train_grasp2vec_pp.gin":
        "tensor2robot_tpu/research/grasp2vec/configs/train_grasp2vec_pp.gin",
}


def test_the_scans_cover_the_pipeline_and_moe_modules():
  assert set(SLICE_19_MODULES) <= set(_port_modules())


def _bindings(path):
  """A gin file's binding statements, without its imports, comments and
  `device_type` bindings."""
  out = set()
  for line in pathlib.Path(path).read_text().splitlines():
    line = line.split("#")[0].strip()
    if line and not line.startswith("import ") and ".device_type" not in line:
      out.add(" ".join(line.split()))
  return out


@pytest.mark.parametrize("name", sorted(SLICE_19_CONFIGS))
def test_pipeline_and_moe_configs_bind_the_jax_configs(name):
  """The port's copy binds what the JAX config binds, but `device_type`,
  and every configurable it binds is the port's."""
  port_path = PORT / "configs" / name
  assert _bindings(port_path) == _bindings(REPO_ROOT /
                                           SLICE_19_CONFIGS[name])
  try:
    config.clear_config()
    config.parse_config_file(str(port_path))
    model = config.query_parameter("train_eval_model.model")
    assert type(model).__module__.startswith("tensor2robot_tpu_torch.")
    rules = config.query_parameter("train_eval_model.partition_rules")
    assert all(isinstance(rule, tuple) for rule in rules)
  finally:
    config.clear_config()


# The compiler tooling's slice: every module the scans above (no jax, no
# tensor2robot_tpu; importable with both blocked) must cover.
SLICE_20_MODULES = (
    "tensor2robot_tpu_torch.obs.excache",
    "tensor2robot_tpu_torch.obs.forge",
    "tensor2robot_tpu_torch.obs.xray",
    "tensor2robot_tpu_torch.utils.backend",
    "tensor2robot_tpu_torch.serving.engine",
    "tensor2robot_tpu_torch.serving.session",
    "tensor2robot_tpu_torch.bin.graftscope",
)


def test_the_scans_cover_the_compile_modules():
  assert set(SLICE_20_MODULES) <= set(_port_modules())


@pytest.mark.parametrize("rel", ["obs/excache.py", "obs/forge.py"])
def test_cache_and_forge_import_torch_only_inside_functions(rel):
  """AST scan: no module-level import of torch or of a JAX module (the
  readers, the keys and the plan run beside a job that owns the card)."""
  tree = ast.parse((PORT / rel).read_text())
  roots = set()
  for node in tree.body:
    if isinstance(node, ast.Import):
      roots |= {alias.name.split(".")[0] for alias in node.names}
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      roots.add((node.module or "").split(".")[0])
  assert not roots & ({"torch", "triton"} | set(FORBIDDEN)), (rel, roots)


def test_cache_readers_and_forge_plan_run_with_torch_and_jax_blocked(
    tmp_path):
  """With torch and jax unimportable: a key from component strings, the
  cache's sidecar readers and `graftscope cache`; with jax unimportable,
  `forge --plan` (a config's own imports load the port's modules, so
  torch with them)."""
  code = (
      "import json, os, sys\n"
      "for name in ('torch', 'jax', 'tensor2robot_tpu', 'triton'):\n"
      "  sys.modules[name] = None\n"
      "from tensor2robot_tpu_torch.obs import excache, forge\n"
      "from tensor2robot_tpu_torch.bin import graftscope\n"
      "key = excache.cache_key('k', args='a', model='m', donation='-',\n"
      "                        device='cpu', mesh='none', versions='v',\n"
      "                        kernels=excache.kernel_fingerprint())\n"
      "d = sys.argv[1]\n"
      "cache = excache.ExecutableCache(d)\n"
      "assert cache.store(key, b'', record={'name': 'k'})\n"
      "assert [e['key'] for e in cache.entries()] == [key]\n"
      "assert graftscope.main(['cache', d, '--verify']) == 0\n"
      "print('COMPILE_TOOLING_FRAMEWORK_FREE_OK')\n")
  result = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO_ROOT, capture_output=True, text=True,
                          timeout=120)
  assert result.returncode == 0, result.stderr[-3000:]
  assert "COMPILE_TOOLING_FRAMEWORK_FREE_OK" in result.stdout
  plan = (
      "import sys\n"
      "for name in ('jax', 'tensor2robot_tpu'):\n"
      "  sys.modules[name] = None\n"
      "from tensor2robot_tpu_torch.bin import graftscope\n"
      "sys.exit(graftscope.main(['forge', 'tensor2robot_tpu_torch/configs/'\n"
      "                          'serve_session.gin', '--plan']))\n")
  result = subprocess.run([sys.executable, "-c", plan], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
  assert result.returncode == 0, result.stderr[-3000:]
  assert "serve/session" in result.stdout
