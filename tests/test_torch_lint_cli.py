"""The port's graftlint CLI and engine (`tensor2robot_tpu_torch.analysis`).

Contracts, the JAX package's (tests/test_static_analysis.py):

* the port itself is permanently clean (`test_port_is_clean`), its
  configs included;
* `--list-rules` is the JAX catalog without the ids that have no torch
  subject, and README.md's rule table is `catalog_markdown()`;
* the CLI exits with the JAX CLI's code for the same argv; its JSON
  output carries severity and suppression provenance, its plain output
  is byte-stable, its baseline fingerprints survive line drift, and its
  incremental cache and `--changed-only` mode report what moved;
* the single-parse engine gives the findings of the per-checker
  pipeline, finding for finding;
* the lint never creates a CUDA context: the CLI runs over the whole
  port in a subprocess whose `torch.cuda._lazy_init` raises.
"""

import json
import os
import subprocess
import sys

import pytest

from tensor2robot_tpu.analysis import lint as jax_lint
from tensor2robot_tpu.utils import config as jax_config
from tensor2robot_tpu_torch.analysis import (cache_check, config_check,
                                             engine as engine_lib,
                                             findings as findings_lib,
                                             fleet_check, forge_check, lint,
                                             loop_check, native_check,
                                             pp_check, retry_check,
                                             session_check, slo_check,
                                             spec_check, thread_check,
                                             trace_check, tracer_check)
from tensor2robot_tpu_torch.bin import graftlint
from tensor2robot_tpu_torch.utils import config

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO_ROOT, "tensor2robot_tpu_torch")
SUBJECTLESS = {"block-until-ready", "pallas-missing-fallback"}


def _rules(findings):
  return {f.rule for f in findings}


def test_port_is_clean():
  findings = lint.run([PORT])
  assert not findings, "graftlint findings in the port:\n" + "\n".join(
      str(f) for f in findings)


def test_list_rules_is_the_jax_catalog_without_the_subjectless_ids(capsys):
  def ids(main):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    return {line.split()[0] for line in out.splitlines()
            if line.startswith("  ") and not line.startswith("   ")}

  port, jax = ids(graftlint.main), ids(jax_lint.main)
  assert port == jax - SUBJECTLESS
  assert SUBJECTLESS <= jax


def test_readme_rule_table_is_the_catalog():
  """README.md's table is generated: regenerate it with
  `engine.catalog_markdown()` after touching any RuleInfo."""
  with open(os.path.join(REPO_ROOT, "README.md")) as f:
    doc = f.read()
  begin = doc.index("<!-- graftlint-torch-catalog:begin -->")
  end = doc.index("<!-- graftlint-torch-catalog:end -->")
  table = doc[begin + len("<!-- graftlint-torch-catalog:begin -->"):end]
  assert table.strip() == engine_lib.catalog_markdown().strip()
  engine_lib.load_builtin_rules()
  for info in engine_lib.rule_infos():
    assert f"`{info.id}`" in table, info.id


def _seed(tmp_path, pkg="tensor2robot_tpu_torch", call="torch.cuda.current_device()"):
  """A fixture tree dense enough that ordering, filtering or suppression
  drift shows: several rule families, a multi-finding file, a syntax
  error, a suppressed finding and a broken config."""
  (tmp_path / "bad_tracer.py").write_text(
      "import time\n"
      "import torch\n"
      "import numpy as np\n"
      f"_D = {call}\n"
      "@torch.compile\n"
      "def step(x):\n"
      "  t = time.time()\n"
      "  return float(x)\n")
  (tmp_path / "bad_spec.py").write_text(
      f"from {pkg} import specs\n"
      "A = specs.TensorSpec(shape=(4,), sharding=('nope',))\n"
      "B = specs.TensorSpec(shape=(4, 4), sharding=('model', 'model'))\n")
  (tmp_path / "bad_syntax.py").write_text("def broken(:\n")
  (tmp_path / "suppressed.py").write_text(
      "import torch\n"
      f"_D = {call}  # graftlint: disable=import-time-backend\n")
  (tmp_path / "bad_config.gin").write_text(
      "NopeNotAThing.x = 1\n"
      "train_eval_model.max_train_steps = 'lots'\n")


@pytest.mark.parametrize("case", ["list", "missing", "unsupported",
                                  "changed_only", "clean", "violations"])
def test_exit_codes_match_the_jax_cli(tmp_path, capsys, case):
  clean = tmp_path / "clean.py"
  clean.write_text("import numpy as np\n\nX = np.zeros(3)\n")
  bad = tmp_path / "bad"
  bad.mkdir()
  (bad / "bad_config.gin").write_text("NopeNotAThing.x = 1\n")
  (bad / "bad_spec.py").write_text(
      "S = specs.TensorSpec(shape=(4,), sharding=('nope',))\n")
  script = tmp_path / "thing.sh"
  script.write_text("echo hi\n")
  argv, want = {
      "list": (["--list-rules"], 0),
      "missing": ([str(tmp_path / "nope")], 2),
      "unsupported": ([str(script)], 2),
      "changed_only": (["--changed-only", str(tmp_path)], 2),
      "clean": ([str(clean)], 0),
      "violations": ([str(bad)], 1),
  }[case]
  assert lint.main(list(argv)) == want
  assert jax_lint.main(list(argv)) == want
  capsys.readouterr()


def test_cli_nonzero_on_violations_names_each_rule(tmp_path, capsys):
  _seed(tmp_path)
  assert graftlint.main([str(tmp_path)]) == 1
  printed = capsys.readouterr().out
  for rule in ("unknown-configurable", "import-time-backend",
               "unknown-mesh-axis", "host-sync-in-jit", "impure-in-jit",
               "parse-error", "type-mismatch"):
    assert rule in printed, printed


def test_single_file_sees_the_port_axis_vocabulary(tmp_path):
  """Linting one .py validates sharding against the axes the port's
  shipped configs declare ('sp'), not just DEFAULT_AXES."""
  model = tmp_path / "model.py"
  model.write_text(
      "from tensor2robot_tpu_torch import specs\n"
      "S = specs.TensorSpec(shape=(4, 4), sharding=('sp', None))\n")
  assert lint.main([str(model)]) == 0


def _per_checker_pipeline(paths):
  """Each checker's standalone entry point over every file (one parse per
  checker per file): the engine must match it finding for finding."""
  py_files, gin_files = engine_lib.discover(list(paths))
  _, port_gin = engine_lib.discover([PORT])
  mesh_axes = spec_check.known_mesh_axes(sorted(set(gin_files)
                                                | set(port_gin)))
  findings = []
  for path in gin_files:
    findings.extend(config_check.check_config_file(path))
  for path in py_files:
    findings.extend(tracer_check.check_python_file(path))
    findings.extend(spec_check.check_python_file(path, mesh_axes))
    for checker in (cache_check, pp_check, session_check, fleet_check,
                    forge_check, retry_check, thread_check, loop_check,
                    trace_check, slo_check):
      findings.extend(checker.check_python_file(path))
    if (os.path.basename(path) == "__init__.py"
        and os.path.basename(os.path.dirname(path)) == "native"):
      findings.extend(native_check.check_native_bindings(
          os.path.dirname(path)))
  return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def test_engine_parity_on_seeded_fixtures(tmp_path):
  _seed(tmp_path)
  old = _per_checker_pipeline([str(tmp_path)])
  result = engine_lib.run_engine([str(tmp_path)])
  assert [str(f) for f in result.findings] == [str(f) for f in old]
  assert len(old) >= 8
  assert "parse-error" in _rules(old)
  assert not any("suppressed.py" in f.path for f in old)
  assert result.stats["parses"] == 4


def test_engine_suppression_provenance_and_json(tmp_path, capsys):
  _seed(tmp_path)
  result = engine_lib.run_engine([str(tmp_path)])
  supp = [(f, line) for f, line in result.suppressed
          if f.path.endswith("suppressed.py")]
  assert [(f.rule, line) for f, line in supp] == [("import-time-backend",
                                                    2)]
  assert lint.main(["--json", str(tmp_path)]) == 1
  records = [json.loads(line)
             for line in capsys.readouterr().out.splitlines()]
  for record in records:
    assert set(record) >= {"path", "line", "rule", "severity", "message",
                           "suppressed"}
    assert record["severity"] in ("error", "warning")
  suppressed = [r for r in records if r["suppressed"]]
  assert [(r["rule"], r["suppressed_by"]) for r in suppressed] == [
      ("import-time-backend", 2)]
  assert all("suppressed_by" not in r for r in records
             if not r["suppressed"])


def test_plain_output_byte_stable(tmp_path, capsys):
  _seed(tmp_path)
  lint.main([str(tmp_path)])
  out = capsys.readouterr().out
  assert out
  for line in out.splitlines():
    assert line.split(":")[1].isdigit(), line
    assert str(findings_lib.Finding(
        line.split(":")[0], int(line.split(":")[1]),
        line.split("[")[1].split("]")[0],
        line.split("] ", 1)[1])) == line


def test_baseline_round_trip_and_line_drift(tmp_path, capsys):
  _seed(tmp_path)
  baseline = tmp_path / "baseline.json"
  assert lint.main(["--write-baseline", str(baseline), str(tmp_path)]) == 0
  capsys.readouterr()
  assert lint.main(["--baseline", str(baseline), str(tmp_path)]) == 0
  assert capsys.readouterr().out == ""
  bad = tmp_path / "bad_tracer.py"
  fingerprints = {engine_lib.finding_fingerprint(f)
                  for f in engine_lib.run_engine([str(tmp_path)]).findings}
  bad.write_text("\n\n" + bad.read_text())
  shifted = engine_lib.run_engine([str(tmp_path)]).findings
  assert {engine_lib.finding_fingerprint(f) for f in shifted} == fingerprints
  (tmp_path / "new_bad.py").write_text(
      "import torch\n_D = torch.cuda.current_device()\n")
  assert lint.main(["--baseline", str(baseline), str(tmp_path)]) == 1
  out = capsys.readouterr().out
  assert "new_bad.py" in out and "bad_tracer.py" not in out
  (tmp_path / "corrupt.json").write_text("{}")
  assert lint.main(["--baseline", str(tmp_path / "corrupt.json"),
                    str(tmp_path)]) == 2


def test_incremental_cache_and_changed_only(tmp_path, capsys):
  _seed(tmp_path)
  cache = tmp_path / "cache.json"
  first = engine_lib.run_engine([str(tmp_path)], cache_path=str(cache))
  assert first.stats["cache_hits"] == 0
  second = engine_lib.run_engine([str(tmp_path)], cache_path=str(cache))
  assert second.stats["cache_hits"] >= 4
  assert [str(f) for f in second.findings] == [str(f) for f in
                                               first.findings]
  assert lint.main(["--cache-file", str(cache), "--changed-only",
                    str(tmp_path)]) == 0
  capsys.readouterr()
  bad = tmp_path / "bad_spec.py"
  bad.write_text(bad.read_text() + "\n# touched\n")
  assert lint.main(["--cache-file", str(cache), "--changed-only",
                    str(tmp_path)]) == 1
  out = capsys.readouterr().out
  assert "bad_spec.py" in out and "bad_tracer.py" not in out
  # The cache stamp includes the mesh-axis vocabulary.
  (tmp_path / "mesh.gin").write_text(
      "train_eval_model.mesh_axis_names = ('data', 'nope')\n")
  third = engine_lib.run_engine([str(tmp_path)], cache_path=str(cache))
  assert third.stats["cache_hits"] == 0
  assert not any(f.rule == "unknown-mesh-axis" and "'nope'" in f.message
                 for f in third.findings)


def test_stats_and_runs_telemetry(tmp_path, capsys):
  from tensor2robot_tpu_torch.obs import runlog

  runs = tmp_path / "runs.jsonl"
  (tmp_path / "clean.py").write_text("X = 1\n")
  assert lint.main(["--stats", "--runs", str(runs),
                    str(tmp_path / "clean.py")]) == 0
  assert "lint/files=1" in capsys.readouterr().err
  records = [json.loads(line) for line in runs.read_text().splitlines()]
  assert len(records) == 1
  assert records[0]["bench"]["name"] == "lint"
  assert records[0]["extra"]["lint"]["files"] == 1
  assert set(runlog.key_metrics(records[0])) == {"lint_parse_ms",
                                                 "lint_rules_ms"}


def test_parse_error_is_unsuppressible(tmp_path):
  (tmp_path / "bad.py").write_text(
      "def broken(:  # graftlint: disable=parse-error\n")
  assert _rules(engine_lib.run_engine([str(tmp_path)]).findings) == {
      "parse-error"}


def test_audit_rules_never_run_in_the_file_walk(tmp_path):
  (tmp_path / "looks_bad.py").write_text(
      "import torch\nTABLE = torch.zeros(512, 512)\n"
      "def fwd(x):\n  return x @ TABLE\n")
  assert not engine_lib.run_engine([str(tmp_path)]).findings
  assert engine_lib.registered_rules()["audit"].kind == "graph"


def test_lint_never_creates_a_cuda_context():
  """The whole port and its configs, linted in a fresh process whose
  `torch.cuda._lazy_init` raises: a module that made a context at import
  would surface as a broken import (exit 1) or an exception."""
  code = """
import sys
import torch
import torch.cuda

def _trap(*args, **kwargs):
  raise RuntimeError("graftlint created a CUDA context")

torch.cuda._lazy_init = _trap
from tensor2robot_tpu_torch.analysis import lint
rc = lint.main(["tensor2robot_tpu_torch"])
assert not torch.cuda.is_initialized()
assert "jax" not in sys.modules and "tensor2robot_tpu" not in sys.modules
print("NO_CUDA_CONTEXT_OK")
sys.exit(rc)
"""
  env = dict(os.environ, PYTHONPATH=REPO_ROOT)
  result = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO_ROOT, env=env)
  assert result.returncode == 0, (result.stdout[-2000:],
                                  result.stderr[-2000:])
  assert "NO_CUDA_CONTEXT_OK" in result.stdout


@pytest.fixture(autouse=True)
def _clean_config():
  config.clear_config()
  jax_config.clear_config()
  yield
  config.clear_config()
  jax_config.clear_config()
