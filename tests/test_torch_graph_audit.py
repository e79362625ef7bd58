"""graftaudit in the port (`analysis/graph_audit.py`): FX-graph auditing
of compiled steps, against the JAX package's jaxpr audit.

Contracts:

* each of the four audit rules FIRES on a seeded fixture through
  `audit_callable` and stays silent on the matching clean control; the
  JAX package's fixture fires the same rule in `jaxpr_audit` (a torch
  twin stands in: a closed-over tensor for a closed-over array, a
  `while_loop` for a `lax.while_loop`, a step that reads its argument's
  identity for an identity-hashed static);
* what has no torch subject: an unhashable static raises in jax and not
  in torch (no finding), and a `scan` body with a host op is refused by
  the trace;
* findings anchor on the audited config with the shared
  `# graftlint: disable=` model, the rules are catalogued as warnings
  (kind "graph") and never run in the file walk;
* `graftscope audit --device cpu` over the two long-context configs, at
  narrow bindings, exits 0, shows the kernel operators in the graphs and
  the arenas written in place, launches no kernel and writes nothing to
  the cache directory; usage errors exit as the JAX CLI's do.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._higher_order_ops.scan import scan
from torch._higher_order_ops.while_loop import while_loop

from tensor2robot_tpu.analysis import jaxpr_audit
from tensor2robot_tpu.bin import graftscope as jax_graftscope
from tensor2robot_tpu_torch.analysis import engine as engine_lib
from tensor2robot_tpu_torch.analysis import graph_audit
from tensor2robot_tpu_torch.bin import graftscope
from tensor2robot_tpu_torch.utils import config

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO_ROOT, "tensor2robot_tpu_torch", "configs")
NARROW = ["SequenceRegressionModel.sequence_length = 64",
          "SequenceRegressionModel.hidden_size = 32",
          "SequenceRegressionModel.num_heads = 2",
          "SessionEngine.max_sessions = 8"]


def _rules(entries):
  return {e["rule"] for e in entries}


# -- audit-baked-constant ----------------------------------------------------------

TABLE = torch.zeros(512, 512)  # exactly 1 MiB
HOST_TABLE = np.zeros((512, 512), np.float32)


def test_baked_constant_fires():
  entries = graph_audit.audit_callable("fixture", lambda x: x @ TABLE,
                                       [torch.ones(4, 512)])
  assert _rules(entries) == {"audit-baked-constant"}
  assert "(512, 512)" in entries[0]["message"]
  assert "1.0 MiB" in entries[0]["message"]
  assert entries[0]["executable"] == "fixture"


def test_host_table_made_inside_the_step_fires():
  entries = graph_audit.audit_callable(
      "fixture", lambda x: x @ torch.as_tensor(HOST_TABLE),
      [torch.ones(4, 512)])
  assert _rules(entries) == {"audit-baked-constant"}


def test_small_constant_argument_and_module_buffer_clean():
  small = torch.zeros(8, 8)
  assert not graph_audit.audit_callable("fixture", lambda x: x @ small,
                                        [torch.ones(4, 8)])
  assert not graph_audit.audit_callable("fixture", lambda x, t: x @ t,
                                        [torch.ones(4, 512), TABLE])
  module = torch.nn.Module()
  module.register_buffer("table", torch.zeros(512, 512))
  assert not graph_audit.audit_callable(
      "fixture", lambda x: x @ module.table, [torch.ones(4, 512)],
      exclude=list(module.buffers()))


def test_baked_constant_threshold_parameterized():
  small = torch.zeros(8, 8)
  traced = graph_audit.trace_graph(lambda x: x @ small, [torch.ones(4, 8)])
  assert _rules(graph_audit.audit_graph("fixture", traced,
                                        const_bytes=64)) == {
                                            "audit-baked-constant"}


# -- audit-undonated-state ----------------------------------------------------------


def _train_like_step(state, batch):
  return state + batch.sum(), (state * state).sum()


STATE = torch.ones(256, 256)  # 256 KiB
BATCH = torch.ones(4, 8)


def test_undonated_state_fires():
  entries = graph_audit.audit_callable("fixture", _train_like_step,
                                       [STATE, BATCH])
  assert _rules(entries) == {"audit-undonated-state"}
  assert "0.2 MiB" in entries[0]["message"]


def test_donated_written_in_place_small_and_frozen_inputs_clean():
  assert not graph_audit.audit_callable("fixture", _train_like_step,
                                        [STATE, BATCH], donate_argnums=(0,))

  def in_place(state, batch):
    state.add_(batch.sum())
    return state, (state * state).sum()

  assert not graph_audit.audit_callable("fixture", in_place,
                                        [STATE.clone(), BATCH])
  assert not graph_audit.audit_callable(
      "fixture", lambda counter, x: (counter + 1, (x * counter).sum()),
      [torch.zeros((), dtype=torch.int32), BATCH])
  assert not graph_audit.audit_callable(
      "fixture", lambda table, x: (x @ table).sum(),
      [torch.zeros(256, 256), torch.ones(4, 256)])


def test_views_of_an_input_written_in_place_are_the_input():
  from tensor2robot_tpu_torch.serving import session

  arena = {"k": torch.zeros(4, 64, 64), "v": torch.zeros(4, 64, 64)}
  traced = graph_audit.trace_graph(session._reset_slot,
                                   [arena, torch.zeros(1, dtype=torch.int64)])
  assert graph_audit.graph_stats(traced)["mutated"] == ["arg0/k", "arg0/v"]

  def row_write(state):
    state[0].mul_(2.0)
    return state * 1.0

  traced = graph_audit.trace_graph(row_write, [STATE.clone()])
  assert graph_audit.graph_stats(traced)["mutated"] == ["arg0"]
  assert not graph_audit.audit_graph("fixture", traced)


# -- audit-host-callback-in-loop ----------------------------------------------------


def _loopy(x):
  def cond(i, v):
    return i < 4

  def body(i, v):
    return i + 1, v + v.sum().item()

  return while_loop(cond, body, (torch.zeros((), dtype=torch.int64), x))


def test_host_op_in_while_loop_fires():
  entries = graph_audit.audit_callable("fixture", _loopy, [torch.ones(2)])
  assert _rules(entries) == {"audit-host-callback-in-loop"}
  assert "'while_loop'" in entries[0]["message"]
  assert "_local_scalar_dense" in entries[0]["message"]


def test_host_op_outside_a_loop_and_loop_without_one_clean():
  assert not graph_audit.audit_callable(
      "fixture", lambda x: x + x.sum().item(), [torch.ones(2)])

  def plain_loop(x):
    return while_loop(lambda i, v: i < 4, lambda i, v: (i + 1, v * 1.5),
                      (torch.zeros((), dtype=torch.int64), x))

  assert not graph_audit.audit_callable("fixture", plain_loop,
                                        [torch.ones(2)])


def test_scan_body_with_a_host_op_is_refused_by_the_trace():
  """The half without a torch subject: the trace refuses a `scan` whose
  body reads a value to the host, so no graph reaches the rule."""
  def scanned(x):
    def step(carry, xs):
      return carry + carry.sum().item(), carry

    return scan(step, x, torch.ones(3, 2))

  with pytest.raises(torch._dynamo.exc.UncapturedHigherOrderOpError):
    graph_audit.trace_graph(scanned, [torch.ones(2)])


# -- audit-unhashable-static ----------------------------------------------------------


class _Config:
  pass


def test_identity_guarded_static_fires():
  entries = graph_audit.audit_callable(
      "fixture", lambda x, cfg: x + (id(cfg) % 2), [torch.ones(2)],
      static_args={"cfg": _Config()})
  assert _rules(entries) == {"audit-unhashable-static"}
  assert "'cfg'" in entries[0]["message"]
  assert "object identity" in entries[0]["message"]


def test_value_guarded_and_unhashable_statics_clean():
  """Dynamo guards a plain object's attributes and a list by value, and
  an unhashable static does not raise in torch (no subject)."""
  for value in (_Config(), [1, 2], {"a": 1}, (1, 2), "train"):
    assert not graph_audit.audit_callable(
        "fixture", lambda x, cfg: x + 1.0, [torch.ones(2)],
        static_args={"cfg": value}), value


# -- parity with the JAX package's fixtures -------------------------------------------


def _jax_fixture(rule):
  if rule == "audit-baked-constant":
    table = jnp.zeros((512, 512), jnp.float32)
    return jaxpr_audit.audit_callable("f", lambda x: x @ table,
                                      [jnp.ones((4, 512), jnp.float32)])
  if rule == "audit-undonated-state":
    return jaxpr_audit.audit_callable(
        "f", lambda s, b: (s + b.sum(), (s * s).sum()),
        [jnp.ones((256, 256), jnp.float32), jnp.ones((4, 8), jnp.float32)])
  if rule == "audit-host-callback-in-loop":
    def loopy(x):
      def body(v):
        return v + jax.pure_callback(
            lambda a: np.asarray(a, np.float32),
            jax.ShapeDtypeStruct((), jnp.float32), v)

      return jax.lax.while_loop(lambda v: v < 4.0, body, x)

    return jaxpr_audit.audit_callable("f", loopy, [jnp.float32(0.0)])
  return jaxpr_audit._audit_static_args("f", {"cfg": _Config()})


def _torch_twin(rule):
  if rule == "audit-baked-constant":
    return graph_audit.audit_callable("f", lambda x: x @ TABLE,
                                      [torch.ones(4, 512)])
  if rule == "audit-undonated-state":
    return graph_audit.audit_callable("f", _train_like_step, [STATE, BATCH])
  if rule == "audit-host-callback-in-loop":
    return graph_audit.audit_callable("f", _loopy, [torch.ones(2)])
  return graph_audit.audit_callable(
      "f", lambda x, cfg: x + (id(cfg) % 2), [torch.ones(2)],
      static_args={"cfg": _Config()})


@pytest.mark.parametrize("rule", ["audit-baked-constant",
                                  "audit-undonated-state",
                                  "audit-host-callback-in-loop",
                                  "audit-unhashable-static"])
def test_rule_fires_on_the_jax_fixture_and_its_torch_twin(rule):
  assert _rules(_jax_fixture(rule)) == {rule}
  assert _rules(_torch_twin(rule)) == {rule}


def test_jax_unhashable_static_has_no_torch_finding():
  assert _rules(jaxpr_audit._audit_static_args("f", {"cfg": [1, 2]})) == {
      "audit-unhashable-static"}
  assert not graph_audit.audit_callable(
      "f", lambda x, cfg: x + len(cfg), [torch.ones(2)],
      static_args={"cfg": [1, 2]})


# -- findings: anchoring, suppression, catalog ----------------------------------------


def _fake_results():
  return [{"name": "train_step", "family": "train", "status": "ok",
           "findings": [graph_audit._entry(
               "train_step", "audit-undonated-state", "2 leaves")]}]


def test_report_findings_anchor_on_config_and_suppress(tmp_path):
  gin = tmp_path / "fixture.gin"
  gin.write_text("a = 1\nb = 2\nc = 3\n")
  plan = {"config_files": [str(gin)]}
  (finding,) = graph_audit.report_findings(plan, _fake_results())
  assert (finding.path, finding.line, finding.end_line) == (str(gin), 1, 4)
  assert finding.rule == "audit-undonated-state"
  assert finding.message == "train_step: 2 leaves"
  (want,) = jaxpr_audit.report_findings(plan, _fake_results())
  assert (str(finding), finding.end_line) == (str(want), want.end_line)
  gin.write_text("a = 1\n"
                 "b = 2  # graftlint: disable=audit-undonated-state\n")
  assert not graph_audit.report_findings(plan, _fake_results())
  gin.write_text("a = 1  # graftlint: disable=audit-baked-constant\n")
  assert len(graph_audit.report_findings(plan, _fake_results())) == 1


def test_audit_rules_catalogued_as_warnings():
  engine_lib.load_builtin_rules()
  ids = {info.id: info for info in engine_lib.rule_infos()}
  for rule in ("audit-baked-constant", "audit-undonated-state",
               "audit-host-callback-in-loop", "audit-unhashable-static"):
    assert ids[rule].severity == "warning"
    assert engine_lib.severity_of(rule) == "warning"
  assert engine_lib.registered_rules()["audit"].kind == "graph"


def test_worker_cli_usage_error():
  result = subprocess.run(
      [sys.executable, "-m", "tensor2robot_tpu_torch.analysis.graph_audit"],
      capture_output=True, text=True, timeout=120, cwd=REPO_ROOT)
  assert result.returncode == 2
  assert "usage" in (result.stderr + result.stdout).lower()


# -- graftscope audit over the shipped configs ---------------------------------------


@pytest.mark.parametrize("argv", [["x"], ["x.gin", "--json"]])
def test_usage_exit_codes_match_the_jax_cli(capsys, argv):
  assert graftscope.main(["audit"] + argv) == 2
  assert "graftscope audit: no such config: x" in capsys.readouterr().err
  assert jax_graftscope.main(["audit"] + argv) == 2
  capsys.readouterr()
  for main in (graftscope.main, jax_graftscope.main):
    with pytest.raises(SystemExit) as exit_info:
      main(["audit"])
    assert exit_info.value.code == 2


def test_serving_config_without_a_model_is_a_usage_error(capsys):
  path = os.path.join(CONFIGS, "serve_session.gin")
  assert graftscope.main(["audit", path, "--device", "cpu"]) == 2
  assert "no model source" in capsys.readouterr().err


@pytest.mark.parametrize("name, extra, ops", [
    ("train_longcontext_flash.gin",
     ["--binding", "SequenceRegressionModel.use_bfloat16 = False"],
     ("train_step", "t2r.flash_fwd x2", "t2r.flash_bwd x2")),
    ("serve_session.gin",
     ["--model", "SequenceRegressionModel", "--binding", NARROW[3]],
     ("serve/session/decode8", "t2r.decode_tick x2"))])
def test_shipped_configs_audit_clean(capsys, name, extra, ops):
  argv = ["audit", os.path.join(CONFIGS, name), "--device", "cpu"] + extra
  for binding in NARROW[:3]:
    argv += ["--binding", binding]
  assert graftscope.main(argv) == 0
  out = capsys.readouterr().out
  assert ("decode" in out) == ("session" in name), out
  assert "0 finding(s) after suppressions" in out
  assert "0 kernel launch(es)" in out
  for op in ops:
    assert op in out, out


def test_session_config_audits_clean_in_place_and_unwritten(tmp_path,
                                                           monkeypatch):
  """Every decode rung holds `t2r.decode_tick` and writes the arenas in
  place; the worker launched no kernel and compiled nothing (its Inductor
  cache directory holds no file)."""
  inductor = tmp_path / "inductor"
  monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(inductor))
  plan, results, findings = graph_audit.audit_config(
      [os.path.join(CONFIGS, "serve_session.gin")], NARROW,
      model="SequenceRegressionModel", device="cpu", timeout_s=300)
  assert not findings
  (result,) = results
  assert result["status"] == "ok" and result["launches"] == 0
  rungs = {g["executable"]: g for g in result["graphs"]}
  assert set(rungs) == {f"serve/session/decode{b}" for b in (1, 2, 4, 8)} | {
      "serve/session/reset_slot"}
  for name, graph in rungs.items():
    arenas = [m for m in graph["mutated"] if "/k_" in m or "/v_" in m]
    assert len(arenas) == 4, (name, graph["mutated"])
    if "decode" in name:
      assert graph["ops"] == {"t2r.decode_tick": 2}, name
  assert [names for _, _, names in os.walk(inductor) if names] == []
  assert plan["targets"][0]["family"] == "session"


@pytest.fixture(autouse=True)
def _clean_config():
  config.clear_config()
  yield
  config.clear_config()
