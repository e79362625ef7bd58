"""Compiled serving rungs, the compile farm and the graftscope CLIs,
against the JAX package, on the CPU.

* `BucketedEngine(cache=...)` compiles each rung (`aot_eager` here): a
  cold warmup is all compile, a second engine on the cache all load, the
  provenance names each rung's key, `rung_cache_keys()` gives those keys
  without compiling, a shared `cache_namespace` shares them across
  engine names, `reladder` compiles its new rung before the swap and a
  reladder back is free, a `restore()` swap recompiles nothing, and every
  served row equals the eager engine's (the JAX package's
  `tests/test_forge.py::TestWarmupSplit` and `TestReladder`).
* `SessionEngine(cache=...)` compiles its decode rungs and the slot
  reset: its ticks equal the eager engine's bit for bit, with no
  recompile, and `rung_cache_keys()` names the stored entries.
* `forge.plan_from_config` on each port config that mirrors a JAX one
  enumerates the JAX plan's targets, families, rungs, replicas and
  executables. Train targets differ by design: the port compiles a one-
  device step (the JAX plan gates its mesh step on its jax version) and
  gates a step on more than one rank.
* The farm on the CPU: `run_forge` compiles a trainer config's step in
  a fresh worker, writes the `forge-manifest-v1` record, and `--verify`
  finds the key a live `train_eval_model(executable_cache_dir=...)` of
  the same config looks up.
* `graftscope cache` and `forge` exit with the JAX CLI's codes.
"""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

from tensor2robot_tpu.bin import graftscope as jax_graftscope
from tensor2robot_tpu.obs import forge as jax_forge
from tensor2robot_tpu_torch import specs as specs_lib
from tensor2robot_tpu_torch import train_eval
from tensor2robot_tpu_torch.bin import graftscope
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.obs import excache
from tensor2robot_tpu_torch.obs import forge
from tensor2robot_tpu_torch.obs import metrics as metrics_lib
from tensor2robot_tpu_torch.obs import runlog
from tensor2robot_tpu_torch.obs import xray
from tensor2robot_tpu_torch.predictors import predictors
from tensor2robot_tpu_torch.serving import engine as engine_lib
from tensor2robot_tpu_torch.serving import session
from tensor2robot_tpu_torch.utils import config

torch.set_num_threads(1)
REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_CONFIGS = REPO_ROOT / "tensor2robot_tpu_torch" / "configs"
JAX_CONFIGS = REPO_ROOT / "tensor2robot_tpu" / "configs"
WIDTHS = dict(obs_size=4, action_size=2, hidden_size=16, num_blocks=1,
              num_heads=2, sequence_length=8, attention_backend="flash")
# The tiny trainer config the farm and the live trainer share.
TRAIN_GIN = f"""
import tensor2robot_tpu_torch.data.input_generators
import tensor2robot_tpu_torch.models.sequence_model
import tensor2robot_tpu_torch.train_eval
train_eval_model.model = @SequenceRegressionModel()
SequenceRegressionModel.obs_size = 4
SequenceRegressionModel.action_size = 2
SequenceRegressionModel.sequence_length = 8
SequenceRegressionModel.hidden_size = 16
SequenceRegressionModel.num_blocks = 1
SequenceRegressionModel.num_heads = 2
SequenceRegressionModel.attention_backend = 'flash'
train_eval_model.input_generator_train = @train/DefaultRandomInputGenerator()
DefaultRandomInputGenerator.batch_size = 2
train_eval_model.mode = 'train'
train_eval_model.max_train_steps = 2
train_eval_model.checkpoint_every_n_steps = 2
train_eval_model.device = 'cpu'
"""


@pytest.fixture(autouse=True)
def _isolated():
  config.clear_config()
  with metrics_lib.isolated():
    xray.clear_records()
    torch._dynamo.reset()
    yield
  config.clear_config()
  xray.clear_records()


def _predictor(seed=0):
  model = sequence_model.SequenceRegressionModel(**WIDTHS)
  predictor = predictors.CheckpointPredictor(model=model, device="cpu")
  predictor.init_randomly(seed)
  return predictor


def _engine(predictor, **kwargs):
  return engine_lib.BucketedEngine(predictor=predictor, max_batch_size=2,
                                   **kwargs)


def _request(predictor, rows, seed):
  return specs_lib.make_random_numpy(predictor.get_feature_specification(),
                                     batch_size=rows, seed=seed)


def test_bucketed_engine_compiles_and_loads_its_rungs(tmp_path):
  cache_dir = str(tmp_path / "excache")
  predictor = _predictor()
  cold = _engine(predictor, cache=cache_dir).warmup()
  provenance = cold.warmup_provenance
  assert [p["rung"] for p in provenance] == [1, 2]
  assert all(p["source"] == "compile" and p["key"] for p in provenance)
  assert cold.compile_count == 2 and cold.cache_loads == 0
  assert cold.warmup_compile_ms > 0 and cold.warmup_load_ms == 0
  keys = {p["rung"]: p["key"] for p in provenance}
  assert _engine(predictor, cache=cache_dir).rung_cache_keys() == keys
  assert all(r["graph_breaks"] == 0 for r in cold.compile_records)
  warm = _engine(predictor, cache=cache_dir).warmup()
  assert warm.compile_count == 0 and warm.cache_loads == 2
  assert all(p["source"] == "cache" for p in warm.warmup_provenance)
  assert warm.warmup_load_ms > 0 and warm.warmup_compile_ms == 0
  eager = _engine(predictor).warmup()
  assert all(p["source"] == "eager" and p["key"] is None
             for p in eager.warmup_provenance)
  assert eager.compile_count == 0 and eager.compile_records == []
  for rows in (1, 2, 5):
    request = _request(predictor, rows, rows)
    got, want = warm.predict(request), eager.predict(request)
    for key in want:
      np.testing.assert_array_equal(got[key], want[key])
  # A namespace shared across engines shares the keys.
  a = _engine(predictor, cache_namespace="serve/loop")
  b = _engine(predictor, cache_namespace="serve/loop")
  assert a.rung_cache_keys() == b.rung_cache_keys() != keys


def test_reladder_compiles_new_rungs_before_the_swap_and_restore_is_free(
    tmp_path):
  predictor = _predictor()
  engine = _engine(predictor, cache=str(tmp_path)).warmup()
  compiles = engine.compile_count
  engine.reladder([1, 3])
  assert engine.buckets == [1, 3]
  assert engine.compile_count == compiles + 1
  assert engine.warmup_provenance[-1]["rung"] == 3
  engine.reladder([1, 2])
  assert engine.compile_count == compiles + 1
  before = engine.predict(_request(predictor, 2, 7))
  # A hot swap to other values: the rung graphs take the state as an
  # input, so nothing recompiles.
  predictor.init_randomly(seed=5)
  after = engine.predict(_request(predictor, 2, 7))
  assert not np.array_equal(before["inference_output"],
                            after["inference_output"])
  assert all(engine._compiled[b].recompiles == 0 for b in (1, 2, 3))
  assert metrics_lib.snapshot().get("counter/xray/recompiles", 0) == 0


def test_session_engine_compiles_its_rungs_and_reset(tmp_path):
  predictor = _predictor()
  engines = {kind: session.SessionEngine(
      predictor=predictor, max_sessions=4, buckets=[1, 2], device="cpu",
      cache=str(tmp_path) if kind == "compiled" else None)
             for kind in ("compiled", "eager")}
  for engine in engines.values():
    engine.warmup()
  compiled = engines["compiled"]
  assert [p["rung"] for p in compiled.warmup_provenance] == [1, 2, "reset"]
  assert all(p["source"] == "compile" for p in compiled.warmup_provenance)
  assert [p["source"] for p in engines["eager"].warmup_provenance] == [
      "eager"] * 3
  keys = compiled.rung_cache_keys()
  assert keys == {p["rung"]: p["key"] for p in compiled.warmup_provenance}
  ok, bad = excache.ExecutableCache(str(tmp_path)).verify()
  assert sorted(ok) == sorted(keys.values()) and bad == []
  assert {r["name"] for r in compiled.compile_records} == {
      "serve/session/decode1", "serve/session/decode2",
      "serve/session/reset_slot"}
  # The decode rungs' flops count every arena position: an upper bound.
  assert {r["name"]: r.get("flops_upper_bound")
          for r in compiled.compile_records} == {
              "serve/session/decode1": ["t2r.decode_tick"],
              "serve/session/decode2": ["t2r.decode_tick"],
              "serve/session/reset_slot": None}
  rs = np.random.RandomState(0)
  sids = {kind: [e.open(), e.open()] for kind, e in engines.items()}
  for tick in range(3):  # 6 ticks of session 0, within its horizon of 8
    obs = [rs.randn(4).astype(np.float32) for _ in range(2)]
    out = {kind: engines[kind].step_many(
        [(sid, {"observation": o}) for sid, o in zip(sids[kind], obs)])
           for kind in engines}
    for got, want in zip(out["compiled"], out["eager"]):
      np.testing.assert_array_equal(got["action"], want["action"])
    # One session alone: the bucket-1 rung.
    one = {kind: engines[kind].step(sids[kind][0], {"observation": obs[0]})
           for kind in engines}
    np.testing.assert_array_equal(one["compiled"]["action"],
                                  one["eager"]["action"])
  for kind, engine in engines.items():
    engine.close_session(sids[kind][1])
    engine.open()  # the reset of a reused slot
  assert all(xf.recompiles == 0 for xf in compiled._compiled.values())
  for a, b in zip(compiled.arena.values(), engines["eager"].arena.values()):
    assert torch.equal(a, b)


def _comparable(target):
  keep = ("family", "name", "buckets", "replica_index", "num_replicas",
          "placed", "executables", "max_sessions")
  return {k: target[k] for k in keep if k in target}


@pytest.mark.parametrize("name", ["serve_session", "serve_qtopt",
                                  "serve_fleet", "loop_qtopt"])
def test_forge_plans_match_the_jax_package(name):
  port = forge.plan_from_config([str(PORT_CONFIGS / f"{name}.gin")])
  jax = jax_forge.plan_from_config([str(JAX_CONFIGS / f"{name}.gin")])
  config.clear_config()
  assert [_comparable(t) for t in port["targets"]] == [
      _comparable(t) for t in jax["targets"]]
  assert (port["model"] is None) == (jax["model"] is None)
  for got, want in zip(port["targets"], jax["targets"]):
    if got["family"] == "train":
      # One device: forgeable in the port, gated on the JAX package's
      # jax version (its donating-mesh pin) there.
      assert got["forgeable"] and got["mesh_shape"] is None
      assert not want["forgeable"] and "donating" in want["reason"]
    else:
      assert got["forgeable"] == want["forgeable"] is True
  assert forge.format_plan(port).startswith("graftforge plan:")


def test_forge_marks_mesh_steps_and_the_eval_step_unforgeable():
  plan = forge.plan_from_config(
      [str(PORT_CONFIGS / "train_sp_ring.gin")],
      ["train_eval_model.mode = 'train_and_evaluate'"])
  config.clear_config()
  train, evaluation = plan["targets"]
  assert not train["forgeable"] and train["reason"] == forge.MESH_REASON
  assert not evaluation["forgeable"]
  assert evaluation["reason"] == forge.EVAL_REASON
  assert forge._bucket_ladder(12) == engine_lib.bucket_ladder(12)


def test_the_farm_forges_the_key_the_live_trainer_looks_up(tmp_path,
                                                           monkeypatch):
  gin = tmp_path / "train_tiny.gin"
  gin.write_text(TRAIN_GIN)
  cache_dir = str(tmp_path / "excache")
  runs = str(tmp_path / "runs.jsonl")
  plan = forge.plan_from_config([str(gin)])
  manifest = forge.run_forge(plan, cache_dir, jobs=1, device="cpu",
                             runs_path=runs, timeout_s=300)
  assert manifest["errors"] == [], manifest["errors"]
  (forged,) = manifest["executables"]
  assert forged["action"] == "compiled" and forged["key"]
  (record,) = runlog.load_records(runs)
  assert record["extra"]["forge"]["schema"] == forge.FORGE_SCHEMA
  report = forge.verify_plan(plan, cache_dir, device="cpu", timeout_s=300)
  assert [e["key"] for e in report["present"]] == [forged["key"]]
  assert report["missing"] == report["corrupt"] == report["errors"] == []
  # The live trainer of the same config hits the forged entry.
  monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "inductor"))
  config.clear_config()
  config.parse_config_file(str(gin))
  config.parse_config(f"train_eval_model.model_dir = '{tmp_path / 'run'}'")
  config.parse_config(f"train_eval_model.executable_cache_dir = "
                      f"'{cache_dir}'")
  train_eval.train_eval_model()
  live = runlog.load_records(str(tmp_path / "run" / "runs.jsonl"))[-1]
  assert live["compile"][0]["cache"] == {
      **live["compile"][0]["cache"], "hit": True, "key": forged["key"]}


def _both(capsys, argv, jax_argv=None):
  port = graftscope.main(list(argv))
  jax = jax_graftscope.main(list(jax_argv or argv))
  capsys.readouterr()
  return port, jax


def test_graftscope_cache_and_forge_exit_with_the_jax_codes(tmp_path,
                                                            capsys):
  fn = xray.XrayedFunction("serve/probe", lambda t: t + 1,
                           cache=str(tmp_path))
  fn(torch.ones(2))
  key = fn.record["cache"]["key"]
  assert _both(capsys, ["cache", str(tmp_path)]) == (0, 0)
  assert _both(capsys, ["cache", str(tmp_path), "--verify"]) == (0, 0)
  (tmp_path / (key + ".bin")).write_bytes(b"torn")
  assert _both(capsys, ["cache", str(tmp_path), "--verify"]) == (1, 1)
  assert _both(capsys, ["cache", str(tmp_path / "none")]) == (2, 2)
  assert graftscope.main(["cache", str(tmp_path), "--evict"]) == 0
  assert os.listdir(tmp_path) == []
  for name in ("serve_session", "serve_fleet"):
    port_cfg, jax_cfg = (str(PORT_CONFIGS / f"{name}.gin"),
                         str(JAX_CONFIGS / f"{name}.gin"))
    assert _both(capsys, ["forge", port_cfg, "--plan"],
                 ["forge", jax_cfg, "--plan"]) == (0, 0)
    # Forgeable targets and no model source: a usage error in both.
    assert _both(capsys, ["forge", port_cfg, "--cache-dir",
                          str(tmp_path)],
                 ["forge", jax_cfg, "--cache-dir", str(tmp_path)]) == (2, 2)
    assert _both(capsys, ["forge", port_cfg, "--cache-dir", "auto",
                          "--model", "SequenceRegressionModel"],
                 ["forge", jax_cfg, "--cache-dir", "auto", "--model",
                  "SequenceRegressionModel"]) == (2, 2)
  assert _both(capsys, ["forge", "/nonexistent.gin", "--plan"]) == (2, 2)
  config.clear_config()


def test_the_loop_threads_one_cache_into_its_replicas_and_learner(
    tmp_path):
  """`run_graftloop.executable_cache_dir = 'auto'` (the JAX loop's
  default): two replicas sharing the 'serve/loop' namespace compile one
  entry set (the second loads it), and the learner's step is compiled
  into the same cache."""
  import subprocess
  import sys

  model_dir = str(tmp_path / "loop")
  result = subprocess.run(
      [sys.executable, "-m", "tensor2robot_tpu_torch.bin.run_graftloop",
       "--config_files", str(PORT_CONFIGS / "loop_qtopt.gin"),
       "--config", f"run_graftloop.model_dir = {model_dir!r}",
       "--config", "run_graftloop.device = 'cpu'",
       "--config", "run_graftloop.steps_per_round = 4",
       "--config", "run_graftloop.num_rounds = 1",
       "--config", "run_graftloop.num_replicas = 2",
       "--config", "run_graftloop.executable_cache_dir = 'auto'",
       "--config", "run_graftloop.wall_timeout_s = 200.0"],
      capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
      env={**os.environ, "PYTHONPATH": str(REPO_ROOT),
           "TORCHINDUCTOR_CACHE_DIR": str(tmp_path / "inductor")})
  assert result.returncode == 0, result.stderr[-3000:]
  summary = json.loads(result.stdout.strip().splitlines()[-1])
  assert summary["episodes"] > 0 and summary["worker_escalations"] == 0
  entries = excache.ExecutableCache(os.path.join(model_dir,
                                                 "excache")).entries()
  names = sorted(e["name"] for e in entries)
  assert names == sorted([f"serve/loop/bucket{b}" for b in (1, 2, 4, 8)]
                         + ["train_step"])
  (record,) = runlog.load_records(os.path.join(model_dir, "runs.jsonl"))
  # The learner shares the process's compile records with the replicas;
  # `runlog` reads the train step's as the primary one.
  assert "train_step" in [r["name"] for r in record["compile"]]
  assert runlog._primary_compile_record(record)["name"] == "train_step"
