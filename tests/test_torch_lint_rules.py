"""graftlint's rules in the port against the JAX package's, rule by rule.

For every rule id of either catalog, a fixture tree — the JAX tests'
seeded fixtures (tests/test_static_analysis.py and the rule tests of
test_overlap, test_graftguard, test_session, test_graftwatch, test_fleet,
test_loop, test_forge, test_excache, test_moe_pipeline, test_graftrace
and test_observability) — goes through both engines, one firing case,
one clean case and one suppressed case per rule. Where the rule's
subject differs (the tracer rules: jax vs torch calls; the cache key's
components; a config's import lines), a torch twin with the same line
layout stands in for the JAX source. The two engines must report the
same (file, line, rule) findings, and suppress the same ones.

The ids without a torch subject (`block-until-ready`,
`pallas-missing-fallback`) fire in the JAX engine on their fixture and
have no stand-in in the port: absent from its catalog, silent on the
same source. The structure-level `sharding-conflict` goes through both
`check_spec_structures`. The four graph-audit ids are held in
tests/test_torch_graph_audit.py. Port-only subjects (the torch host
syncs and CUDA-context calls, `XrayedFunction` steps, `.cpu()` fetches of
session state, the native library's file stem) close the file.
"""

import os

import pytest

from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu.analysis import engine as jax_engine
from tensor2robot_tpu.analysis import spec_check as jax_spec_check
from tensor2robot_tpu.utils import config as jax_config
from tensor2robot_tpu.utils import mocks as jax_mocks  # noqa: F401
from tensor2robot_tpu_torch import specs
from tensor2robot_tpu_torch.analysis import cache_check
from tensor2robot_tpu_torch.analysis import engine
from tensor2robot_tpu_torch.analysis import native_check
from tensor2robot_tpu_torch.analysis import session_check
from tensor2robot_tpu_torch.analysis import spec_check
from tensor2robot_tpu_torch.analysis import tracer_check
from tensor2robot_tpu_torch.obs import excache
from tensor2robot_tpu_torch.utils import config
from tensor2robot_tpu_torch.utils import mocks  # noqa: F401

SUBJECTLESS = ("block-until-ready", "pallas-missing-fallback")


def _same(src):
  return (src, src)


def _gin(text):
  """A config's JAX text and its port twin (the package in import
  lines)."""
  return (text.format(pkg="tensor2robot_tpu"),
          text.format(pkg="tensor2robot_tpu_torch"))


_GUARDED_PALLAS = ("try:\n"
                   "  from jax.experimental import pallas as pl\n"
                   "except ImportError:\n"
                   "  pl = None\n")
_RETRY = """
import time

def fetch(source):
  for attempt in range(5):
    try:
      return source.read()
    except Exception:
      pass
    time.sleep(0.5)
"""
_TIMING = """
import time
{imports}

def f(x):
  t0 = time.perf_counter()
  y = {op}
{barrier}  return time.perf_counter() - t0{suppress}
"""


def _timing(suppress="", barrier=""):
  jax_src = _TIMING.format(
      imports="import jax.numpy as jnp\nimport numpy as np",
      op="jnp.dot(x, x)",
      barrier="  np.asarray(y)\n" if barrier else "", suppress=suppress)
  torch_src = _TIMING.format(
      imports="import torch\nimport numpy as np",
      op="torch.matmul(x, x)",
      barrier="  torch.cuda.synchronize()\n" if barrier else "",
      suppress=suppress)
  return jax_src, torch_src


def _tracer(fn_jax, fn_torch, body):
  """A compiled function's source in both packages: `body` under
  `{compile}` (a decorator or a call)."""
  return (body.format(imp="import jax", compile=fn_jax),
          body.format(imp="import torch", compile=fn_torch))


_NATIVE_CC = ('extern "C" {\n'
              "int64_t t2r_bound(void* h) { return 0; }\n"
              "void* t2r_unbound(void* h) { return h; }\n"
              "}\n")

# rule id -> {"fire" | "clean" | "suppressed": {relpath: (jax, torch)}}.
CASES = {
    "parse-error": {
        "fire": {"bad_syntax.py": _same("def broken(:\n"),
                 "bad.gin": _same("a line without an equals sign\n")},
        "clean": {"ok.py": _same("X = 1\n")},
        # Unsuppressible: an unparseable file has no trusted comments.
        "suppressed": {"bad2.py": _same(
            "def broken(:  # graftlint: disable=parse-error\n")},
    },
    "broken-import": {
        "fire": {"c.gin": _gin("import {pkg}.no_such_module\n"),
                 "inc.gin": _same("include 'missing.gin'\n")},
        "clean": {"c.gin": _gin("import {pkg}.utils.mocks\n")},
        "suppressed": {"c.gin": _gin(
            "import {pkg}.no_such_module"
            "  # graftlint: disable=broken-import\n")},
    },
    "unknown-configurable": {
        "fire": {"c.gin": _same("TotallyUnknownThing.param = 1\n")},
        "clean": {"c.gin": _same("train_eval_model.max_train_steps = 5\n")},
        "suppressed": {"c.gin": _same(
            "TotallyUnknownThing.param = [\n"
            "    1,\n"
            "]  # graftlint: disable=unknown-configurable\n")},
    },
    "missing-import": {
        "fire": {"c.gin": _same("MockT2RModel.use_batch_norm = False\n")},
        "clean": {"c.gin": _gin("import {pkg}.utils.mocks\n"
                                "MockT2RModel.use_batch_norm = False\n")},
        "suppressed": {"c.gin": _same(
            "MockT2RModel.use_batch_norm = False"
            "  # graftlint: disable=missing-import\n")},
    },
    "unknown-parameter": {
        "fire": {"c.gin": _gin("import {pkg}.utils.mocks\n"
                               "MockInputGenerator.not_a_real_parameter = 3"
                               "\n")},
        "clean": {"c.gin": _gin("import {pkg}.utils.mocks\n"
                                "MockT2RModel.not_a_real_parameter = 3\n")},
        "suppressed": {"c.gin": _gin(
            "import {pkg}.utils.mocks\n"
            "MockInputGenerator.not_a_real_parameter = 3"
            "  # graftlint: disable=unknown-parameter\n")},
    },
    "duplicate-binding": {
        "fire": {"c.gin": _same("train_eval_model.max_train_steps = 5\n"
                                "train_eval_model.max_train_steps = 9\n")},
        "clean": {"base.gin": _same("train_eval_model.max_train_steps = 5\n"),
                  "c.gin": _same("include 'base.gin'\n"
                                 "train_eval_model.max_train_steps = 9\n")},
        "suppressed": {"c.gin": _same(
            "train_eval_model.max_train_steps = 5\n"
            "train_eval_model.max_train_steps = 9"
            "  # graftlint: disable=duplicate-binding\n")},
    },
    "undefined-macro": {
        "fire": {"c.gin": _same(
            "OTHER = %NEVER_DEFINED\n"
            "train_eval_model.max_train_steps = %OTHER\n")},
        "clean": {"c.gin": _same(
            "NUM_STEPS = 7\n"
            "train_eval_model.max_train_steps = %NUM_STEPS\n")},
        "suppressed": {"c.gin": _same(
            "train_eval_model.max_train_steps = %NOT_DEFINED"
            "  # graftlint: disable=undefined-macro\n")},
    },
    "type-mismatch": {
        "fire": {"c.gin": _same("train_eval_model.max_train_steps = 'lots'\n"
                                "train_eval_model.model_dir = 3\n")},
        "clean": {"c.gin": _gin("import {pkg}.utils.mocks\n"
                                "train_eval_model.eval_throttle_secs = 5\n"
                                "train_eval_model.model = @MockT2RModel()\n")},
        "suppressed": {"c.gin": _same(
            "train_eval_model.max_train_steps = 'lots'"
            "  # graftlint: disable=type-mismatch\n")},
    },
    "import-time-backend": {
        "fire": {
            "mod.py": ("import jax\n_D = jax.devices()\n",
                       "import torch\n_D = torch.cuda.current_device()\n"),
            "default.py": ("import jax.numpy as jnp\n"
                           "def f(x=jnp.zeros(3)):\n  return x\n",
                           "import torch\n"
                           "def f(x=torch.zeros(3, device='cuda')):\n"
                           "  return x\n"),
            "decorator.py": ("import functools\n"
                             "import jax.numpy as jnp\n"
                             "def register(fn, table):\n  return fn\n"
                             "@functools.partial(register, table=jnp.eye(3))\n"
                             "def f(x):\n  return x\n",
                             "import functools\n"
                             "import torch\n"
                             "def register(fn, table):\n  return fn\n"
                             "@functools.partial(register, table=torch.eye("
                             "3).cuda())\n"
                             "def f(x):\n  return x\n"),
        },
        "clean": {"mod.py": (
            "import jax\n_OK = True\n"
            "def also_fine():\n  return jax.devices()\n"
            "@jax.jit\ndef g(x):\n  return x\n"
            "if __name__ == '__main__':\n  print(jax.default_backend())\n",
            "import torch\n_OK = torch.cuda.is_available()\n"
            "def also_fine():\n  return torch.cuda.current_device()\n"
            "@torch.compile\ndef g(x):\n  return x\n"
            "if __name__ == '__main__':\n  print(torch.cuda.current_device())"
            "\n")},
        "suppressed": {"mod.py": (
            "import jax\n_D = jax.devices(\n"
            ")  # graftlint: disable=import-time-backend\n",
            "import torch\n_D = torch.cuda.current_device(\n"
            ")  # graftlint: disable=import-time-backend\n")},
    },
    "host-sync-in-jit": {
        "fire": {"mod.py": _tracer("jax.jit", "torch.compile", (
            "{imp}\nimport numpy as np\n\n@{compile}\ndef step(x, y):\n"
            "  v = float(x)\n  w = np.asarray(y)\n  return x.sum().item()\n\n"
            "def _wrapped(a):\n  return int(a)\n\n"
            "wrapped = {compile}(_wrapped)\n"))},
        "clean": {"mod.py": _tracer("jax.jit", "torch.compile", (
            "{imp}\nimport numpy as np\n\ndef fine(x):\n"
            "  return float(np.asarray(x).item())\n\n"
            "@{compile}\ndef step(x, n):\n  return x * 2\n"))},
        "suppressed": {"mod.py": _tracer("jax.jit", "torch.compile", (
            "{imp}\n\n@{compile}\ndef step(x):\n"
            "  return x.sum().item()  # graftlint: disable=host-sync-in-jit"
            "\n"))},
    },
    "impure-in-jit": {
        "fire": {"mod.py": (
            "import functools\nimport time\nimport jax\nimport numpy as np\n"
            "@jax.jit\ndef step(x):\n  t = time.time()\n"
            "  z = np.random.rand(3)\n  return x\n"
            "@functools.partial(jax.jit, static_argnums=0)\n"
            "def step2(n, x):\n  return np.random.randint(0, n)\n",
            "import functools\nimport time\nimport torch\nimport numpy as np\n"
            "@torch.compile\ndef step(x):\n  t = time.time()\n"
            "  z = np.random.rand(3)\n  return x\n"
            "@functools.partial(torch.compile, dynamic=False)\n"
            "def step2(n, x):\n  return np.random.randint(0, n)\n")},
        "clean": {"mod.py": _tracer("jax.jit", "torch.compile", (
            "import time\n{imp}\nimport numpy as np\n"
            "def host():\n  return time.time(), np.random.rand(3)\n"
            "@{compile}\ndef step(x):\n"
            "  rng = np.random.default_rng(0)\n  return x\n"))},
        "suppressed": {"mod.py": _tracer("jax.jit", "torch.compile", (
            "import time\n{imp}\n@{compile}\ndef step(x):\n"
            "  t = time.time()  # graftlint: disable=impure-in-jit\n"
            "  return x\n"))},
    },
    "device-timing": {
        "fire": {"mod.py": _timing()},
        "clean": {"mod.py": _timing(barrier=True),
                  "obs/clock.py": _timing()},
        "suppressed": {"mod.py": _timing(
            suppress="  # graftlint: disable=device-timing")},
    },
    "block-until-ready": {
        "fire": {"mod.py": _same(
            "import jax\ndef barrier(x):\n"
            "  return jax.block_until_ready(x)\n")},
        "clean": {"utils/backend.py": _same(
            "import jax\ndef sync(x):\n  return jax.block_until_ready(x)\n")},
        "suppressed": {"mod.py": _same(
            "import jax\ndef barrier(x):\n  return jax.block_until_ready(x)"
            "  # graftlint: disable=block-until-ready\n")},
    },
    "pallas-missing-fallback": {
        "fire": {"k.py": _same("from jax.experimental import pallas as pl\n"
                               "out = pl.pallas_call(kernel)(x)\n")},
        "clean": {"k.py": _same(_GUARDED_PALLAS
                                + "out = pl.pallas_call(kernel, "
                                  "interpret=flag)(x)\n")},
        "suppressed": {"k.py": _same(
            "out = pallas_call(kernel)"
            "  # graftlint: disable=pallas-missing-fallback\n")},
    },
    "trace-context-dropped": {
        "fire": {"m.py": _same("def append(self, items, trace_ctx=None):\n"
                               "  self._items.extend(items)\n"
                               "async def handle(batch, *, trace_ctx):\n"
                               "  await process(batch)\n")},
        "clean": {"m.py": _same("def submit(pool, trace_ctx):\n"
                                "  def work():\n"
                                "    record(trace_ctx)\n"
                                "  pool.submit(work)\n")},
        "suppressed": {"m.py": _same(
            "def stub(trace_ctx=None):"
            "  # graftlint: disable=trace-context-dropped\n  pass\n")},
    },
    "cache-key-missing-component": {
        "fire": {"m.py": ("key = cache_key('fn', avals=b)\n",
                          "key = cache_key('fn', args=b)\n")},
        "clean": {"m.py": (
            "key1 = cache_key('fn', jaxpr_fingerprint=a, avals=b, mesh=c,\n"
            "                 backend_version=d, donation=e, static_args=f,\n"
            "                 pallas=g)\n"
            "key2 = cache_key('fn', **components)\n",
            "key1 = cache_key('fn', args=a, model=b, donation=c,\n"
            "                 device=d, mesh=e, versions=f,\n"
            "                 kernels=g)\n"
            "key2 = cache_key('fn', **components)\n")},
        "suppressed": {"m.py": (
            "key = cache_key('fn', avals=b)"
            "  # graftlint: disable=cache-key-missing-component\n",
            "key = cache_key('fn', args=b)"
            "  # graftlint: disable=cache-key-missing-component\n")},
    },
    "pp-schedule-unaudited": {
        "fire": {"m.py": _same(
            "step = pp.make_pipelined_train_step(fn, loss, opt, mesh)\n"
            "step = make_pipelined_train_step(fn, loss, opt, mesh,\n"
            "                                 audit_name=None)\n")},
        "clean": {"m.py": _same(
            "s = make_pipelined_train_step(fn, loss, opt, mesh,\n"
            "                              audit_name='run/pp_step')\n"
            "s = make_pipelined_train_step(fn, loss, opt, mesh, **kw)\n")},
        "suppressed": {"m.py": _same(
            "s = make_pipelined_train_step(fn, loss, opt, mesh)"
            "  # graftlint: disable=pp-schedule-unaudited\n")},
    },
    "session-state-leak": {
        "fire": {"m.py": _same(
            "import numpy as np\n"
            "def f(decode_step, s, sess, o, session_state, engine):\n"
            "  decode_step(s, sess, o)\n"
            "  _, out = decode_step(s, sess, o)\n"
            "  a = np.asarray(session_state)\n"
            "  b = np.asarray(engine._arena)\n")},
        "clean": {"m.py": _same(
            "import numpy as np\n"
            "def f(decode_step, s, sess, o, out):\n"
            "  sess, out = decode_step(s, sess, o)\n"
            "  c = np.asarray(out)\n")},
        "suppressed": {"m.py": _same(
            "def f(decode_step, s, sess, o):\n"
            "  decode_step(s, sess, o)"
            "  # graftlint: disable=session-state-leak\n")},
    },
    "bare-retry-rule": {
        "fire": {"serving/mod.py": _same(_RETRY),
                 "data/mod.py": _same(_RETRY)},
        "clean": {"models/mod.py": _same(_RETRY),
                  "serving/poll.py": _same(
                      "import time\n\ndef wait(flag):\n"
                      "  while not flag.is_set():\n    time.sleep(0.005)\n")},
        "suppressed": {"serving/mod.py": _same(_RETRY.replace(
            "for attempt in range(5):",
            "for attempt in range(5):  # graftlint: disable=bare-retry-rule"))},
    },
    "fleet-replica-unjoined": {
        "fire": {"t.py": _same(
            "def f():\n"
            "  fleet = ServingFleet(replica_factory=g)\n"
            "  fleet.predict({})\n"
            "def outer():\n"
            "  def inner():\n"
            "    fleet = ServingFleet(replica_factory=g)\n"
            "    fleet.predict({})\n"
            "  fleet2 = ServingFleet(replica_factory=g)\n"
            "  fleet2.close()\n")},
        "clean": {"t.py": _same(
            "def f():\n  fleet = ServingFleet(replica_factory=g)\n"
            "  try:\n    fleet.predict({})\n  finally:\n    fleet.close()\n"
            "def g2():\n  with ServingFleet(replica_factory=g) as fleet:\n"
            "    fleet.predict({})\n"
            "def h():\n  return ServingFleet(replica_factory=g)\n")},
        "suppressed": {"t.py": _same(
            "def server():\n"
            "  fleet = ServingFleet(replica_factory=g)"
            "  # graftlint: disable=fleet-replica-unjoined\n"
            "  fleet.predict({})\n")},
    },
    "warmup-unforgeable": {
        "fire": {"x.py": _same(
            "from tensor2robot_tpu import serving\n"
            "ladder = serving.engine.traffic_bucket_ladder(sizes, 16)\n"
            "engine = serving.BucketedEngine(predictor=p, buckets=ladder)\n"
            "session = serving.SessionEngine(predictor=p,\n"
            "                                buckets=derive_buckets_somehow())"
            "\n")},
        "clean": {"x.py": _same(
            "MY_BUCKETS = (1, 2, 4)\n"
            "a = serving.BucketedEngine(predictor=p)\n"
            "b = serving.BucketedEngine(predictor=p, buckets=[1, 2, 8])\n"
            "d = serving.BucketedEngine(predictor=p, buckets=MY_BUCKETS)\n"
            "e = serving.BucketedEngine(predictor=p, buckets=bucket_ladder(16))"
            "\nf = serving.SessionEngine(predictor=p, **kwargs)\n")},
        "suppressed": {"x.py": _same(
            "engine = serving.BucketedEngine("
            "  # graftlint: disable=warmup-unforgeable\n"
            "    predictor=p, buckets=derived())\n")},
    },
    "unsupervised-loop-worker": {
        "fire": {"loop/worker.py": _same(
            "import threading\ndef start():\n"
            "  t = threading.Thread(target=work)\n  t.start()\n")},
        "clean": {"loop/supervisor.py": _same(
            "import threading\nt = threading.Thread(target=mon)\n"),
            "data/overlap.py": _same(
                "import threading\nt = threading.Thread(target=w)\n"),
            "loop/actor.py": _same("def start(sup):\n"
                                   "  sup.spawn('actor-0', actor.run)\n")},
        "suppressed": {"loop/worker.py": _same(
            "import threading\nt = threading.Thread(target=w)"
            "  # graftlint: disable=unsupervised-loop-worker\n")},
    },
    "thread-stage-missing-close": {
        "fire": {"m.py": _same(
            "import threading\nclass Stage:\n  def start(self):\n"
            "    self._t = threading.Thread(target=print)\n"
            "    self._t.start()\n")},
        "clean": {"m.py": _same(
            "import threading\ndef run_load():\n"
            "  t = threading.Thread(target=print)\n  t.start()\n  t.join()\n")},
        "suppressed": {"m.py": _same(
            "import threading\nclass Stage:\n  def start(self):\n"
            "    self._t = threading.Thread(\n"
            "        target=print)"
            "  # graftlint: disable=thread-stage-missing-close\n")},
    },
    "thread-stage-missing-backstop": {
        "fire": {"m.py": _same(
            "import threading\nclass Stage:\n  def start(self):\n"
            "    self._t = threading.Thread(target=print)\n"
            "  def close(self):\n    self._t.join()\n")},
        "clean": {"m.py": _same(
            "import threading, weakref\nclass Stage:\n"
            "  def __init__(self):\n    stop = threading.Event()\n"
            "    self._t = threading.Thread(target=print)\n"
            "    self._fin = weakref.finalize(self, stop.set)\n"
            "  def close(self):\n    self._t.join()\n")},
        "suppressed": {"m.py": _same(
            "import threading\nclass Stage:\n  def start(self):\n"
            "    self._t = threading.Thread(target=print)"
            "  # graftlint: disable=thread-stage-missing-backstop\n"
            "  def close(self):\n    self._t.join()\n")},
    },
    "native-binding-missing": {
        "fire": {"native/x.cc": _same(_NATIVE_CC),
                 "native/__init__.py": _same(
                     "lib.t2r_bound.restype = ctypes.c_int64\n")},
        "clean": {"native/x.cc": _same(_NATIVE_CC),
                  "native/__init__.py": _same(
                      "lib.t2r_bound.restype = ctypes.c_int64\n"
                      'if hasattr(lib, "t2r_unbound"):\n  pass\n')},
        "suppressed": {"native/x.cc": _same(_NATIVE_CC),
                       "native/__init__.py": _same(
                           "lib.t2r_bound.restype = ctypes.c_int64"
                           "  # graftlint: disable=native-binding-missing\n")},
    },
    "native-binding-unknown": {
        "fire": {"native/x.cc": _same(
            'extern "C" int64_t t2r_bound(void* h) { return 0; }\n'),
            "native/__init__.py": _same(
                "lib.t2r_bound.restype = ctypes.c_int64\n"
                "lib.t2r_typoed.restype = None\n")},
        "clean": {"native/x.cc": _same(
            'extern "C" uint32_t t2r_crc(const uint8_t* d, int64_t n);\n'
            'extern "C" {\n'
            "uint32_t t2r_crc(const uint8_t* d, int64_t n) {\n"
            "  if (t2r_crc(d, 0)) return t2r_crc(d, 1);\n  return 0;\n}\n}\n"),
            "native/__init__.py": _same(
                '"""Wrapper for libt2r_native.so; see the `t2r_*` exports.'
                '"""\nlib.t2r_crc.restype = ctypes.c_uint32\n')},
        "suppressed": {"native/x.cc": _same(
            'extern "C" int64_t t2r_bound(void* h) { return 0; }\n'),
            "native/__init__.py": _same(
                "lib.t2r_bound.restype = ctypes.c_int64\n"
                "lib.t2r_gone.restype = None"
                "  # graftlint: disable=native-binding-unknown\n")},
    },
    "slo-unbudgeted": {
        "fire": {"m.py": _same(
            "s = SloSpec('a', bad_key='b', total_key='c')\n"
            "t = slo.SloSpec('a', budget=0.1, bad_key='b',\n"
            "                total_key='c')\n"
            "KIND = 'serving_" "slo_burn'\n")},
        "clean": {"m.py": _same(
            "s = SloSpec('a', budget=0.1, fast_window_s=1.0,\n"
            "            slow_window_s=2.0, bad_key='b', total_key='c')\n"
            "s = SloSpec('a', **kw)\n"),
            "obs/sentinel.py": _same("KIND = 'serving_" "slo_burn'\n")},
        "suppressed": {"m.py": _same(
            "s = SloSpec('a', bad_key='b', total_key='c')"
            "  # graftlint: disable=slo-unbudgeted\n")},
    },
    "unknown-mesh-axis": {
        "fire": {"s.py": _same(
            "S = specs.TensorSpec(shape=(8, 4), sharding=(None, 'modle'))\n")},
        "clean": {"s.py": _same(
            "S = specs.TensorSpec(shape=(8, 4), sharding=(None, 'model'))\n")},
        "suppressed": {"s.py": _same(
            "S = specs.TensorSpec(\n    shape=(4,),\n"
            "    sharding=('custom',))  # graftlint: disable=unknown-mesh-axis"
            "\n")},
    },
    "duplicate-sharding-axis": {
        "fire": {"s.py": _same(
            "D = specs.TensorSpec(shape=(8, 4), sharding=('model', 'model'))\n"
        )},
        "clean": {"s.py": _same(
            "D = specs.TensorSpec(shape=(8, 4), sharding=('data', 'model'))\n"
        )},
        "suppressed": {"s.py": _same(
            "D = specs.TensorSpec(shape=(8, 4), sharding=('model', 'model'))"
            "  # graftlint: disable=duplicate-sharding-axis\n")},
    },
    "sharding-rank-mismatch": {
        "fire": {"s.py": _same(
            "L = specs.TensorSpec(shape=(8,), sharding=('data', 'model'))\n")},
        "clean": {"s.py": _same(
            "L = specs.TensorSpec(shape=(8, 2), sharding=('data', 'model'))\n"
        )},
        "suppressed": {"s.py": _same(
            "L = specs.TensorSpec(shape=(8,), sharding=('data', 'model'))"
            "  # graftlint: disable=sharding-rank-mismatch\n")},
    },
}
AUDIT_IDS = ("audit-baked-constant", "audit-undonated-state",
             "audit-host-callback-in-loop", "audit-unhashable-static")


def _write(root, files, side):
  for relpath, pair in files.items():
    path = root / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(pair[side])


def _report(result, root):
  def rel(f):
    return os.path.relpath(f.path, root)

  return ([(rel(f), f.line, f.rule) for f in result.findings],
          [(rel(f), f.line, f.rule, at) for f, at in result.suppressed])


def _both(tmp_path, files):
  """(JAX engine's report, port engine's report) over the fixture tree."""
  reports = []
  for side, run in ((0, jax_engine.run_engine), (1, engine.run_engine)):
    root = tmp_path / ("jax", "torch")[side]
    _write(root, files, side)
    reports.append(_report(run([str(root)]), root))
  return reports


def test_the_cases_cover_both_catalogs():
  """Every id of either catalog has its fixtures here, or (the graph
  audit's) in tests/test_torch_graph_audit.py."""
  jax_engine.load_builtin_rules()
  engine.load_builtin_rules()
  jax_ids = {i.id for i in jax_engine.rule_infos()}
  port_ids = {i.id for i in engine.rule_infos()}
  assert set(CASES) | set(AUDIT_IDS) | {"sharding-conflict"} == (
      jax_ids | port_ids)
  assert port_ids == jax_ids - set(SUBJECTLESS)


@pytest.mark.parametrize("rule", [r for r in CASES if r not in SUBJECTLESS])
def test_rule_gives_the_same_findings_in_both_engines(tmp_path, rule):
  cases = CASES[rule]
  fired, fired_port = _both(tmp_path / "fire", cases["fire"])
  assert fired == fired_port
  assert any(r == rule for _, _, r in fired[0]), fired
  clean, clean_port = _both(tmp_path / "clean", cases["clean"])
  assert clean == clean_port
  assert not any(r == rule for _, _, r in clean[0]), clean
  supp, supp_port = _both(tmp_path / "suppressed", cases["suppressed"])
  assert supp == supp_port
  if rule == "parse-error":
    assert [r for _, _, r in supp[0]] == ["parse-error"]
  else:
    assert not any(r == rule for _, _, r in supp[0]), supp
  if rule not in ("parse-error",) and not rule.endswith(
      ("import", "configurable", "parameter", "binding", "macro",
       "mismatch")) and "native" not in rule:
    # Provenance: the engine's own suppression pass reports what the
    # comment ate (config and native rules filter themselves).
    assert any(r == rule for _, _, r, _ in supp[1]), supp


@pytest.mark.parametrize("rule", SUBJECTLESS)
def test_subjectless_rule_has_no_stand_in(tmp_path, rule):
  """The JAX engine fires on the JAX fixture; the port's catalog lacks
  the id and its engine stays silent on the same source."""
  jax_report, port_report = _both(tmp_path, CASES[rule]["fire"])
  assert {r for _, _, r in jax_report[0]} == {rule}
  assert port_report == ([], [])
  engine.load_builtin_rules()
  assert rule not in {i.id for i in engine.rule_infos()}
  assert rule not in engine.catalog_text()


def test_sharding_conflict_in_both_structure_checkers():
  for spec_lib, checker in ((jax_specs, jax_spec_check),
                            (specs, spec_check)):
    feature = spec_lib.SpecStruct()
    feature["state/obs"] = spec_lib.TensorSpec(shape=(8, 4),
                                               sharding=(None, "model"))
    label = spec_lib.SpecStruct()
    label["state/obs"] = spec_lib.TensorSpec(shape=(8, 4),
                                             sharding=("model", None))
    out = checker.check_spec_structures(feature, label,
                                        mesh_axes={"data", "fsdp", "model"})
    assert {f.rule for f in out} == {"sharding-conflict"}
    assert not checker.check_spec_structures(
        feature, feature, mesh_axes={"data", "fsdp", "model"})


def test_cache_components_are_cache_keys_keywords():
  import inspect

  kwonly = {name for name, p in inspect.signature(
      excache.cache_key).parameters.items()
            if p.kind == inspect.Parameter.KEYWORD_ONLY}
  assert kwonly == set(cache_check.REQUIRED_COMPONENTS)


# -- the port's own subjects ------------------------------------------------------


def _rules_lines(findings):
  return sorted((f.line, f.rule) for f in findings)


def test_compiled_regions_of_the_port():
  """A function handed to `XrayedFunction(name, fn)` or `analyze_jit(name,
  fn, ...)` is compiled; `.tolist()`, `.cpu()` and `.numpy()` are host
  syncs inside it."""
  src = ("from tensor2robot_tpu_torch.obs import xray\n"
         "def step(x):\n"
         "  a = x.tolist()\n"
         "  b = x.cpu()\n"
         "  return x.numpy()\n"
         "f = xray.XrayedFunction('step', step)\n"
         "def other(x):\n"
         "  return x.cpu()\n"
         "xray.analyze_jit('other', other, 1)\n"
         "def eager(x):\n"
         "  return x.cpu()\n")
  assert _rules_lines(tracer_check.check_python_source(src, "m.py")) == [
      (3, "host-sync-in-jit"), (4, "host-sync-in-jit"),
      (5, "host-sync-in-jit"), (8, "host-sync-in-jit")]


def test_import_time_cuda_context_calls():
  src = ("import torch\n"
         "A = torch.ones(3).cuda()\n"
         "B = torch.ones(3).to('cuda:0')\n"
         "C = torch.zeros(2, device=torch.device('cuda'))\n"
         "D = torch.cuda.get_device_name(0)\n"
         "E = torch.zeros(2, device='cpu')\n"
         "F = torch.cuda.device_count()\n"
         "G = torch.ones(3).to('cpu')\n")
  assert _rules_lines(tracer_check.check_python_source(src, "m.py")) == [
      (line, "import-time-backend") for line in (2, 3, 4, 5)]


def test_device_timing_barriers_of_the_port():
  """An event's synchronize(), backend.sync and a host fetch end the
  window; a torch op outside any window, or a host-only torch call
  inside one, is not timed dispatch."""
  for barrier in ("end.synchronize()", "backend.sync(y)", "y.cpu()",
                  "float(y.sum())"):
    src = ("import time\nimport torch\n"
           "def f(x, end, backend):\n"
           "  t0 = time.perf_counter()\n"
           "  y = torch.nn.functional.relu(x)\n"
           f"  {barrier}\n"
           "  return time.perf_counter() - t0\n")
    assert not tracer_check.check_python_source(src, "m.py"), barrier
  host_only = ("import time\nimport torch\n"
               "def f():\n"
               "  t0 = time.perf_counter()\n"
               "  g = torch.Generator().manual_seed(0)\n"
               "  with torch.no_grad():\n"
               "    d = torch.device('cuda')\n"
               "  return time.perf_counter() - t0\n")
  assert not tracer_check.check_python_source(host_only, "m.py")


def test_session_state_fetch_methods():
  src = ("def f(engine, session_state, out):\n"
         "  a = engine._arena['k'].cpu()\n"
         "  b = session_state.tolist()\n"
         "  c = out.cpu()\n")
  assert _rules_lines(session_check.check_python_source("m.py", src)) == [
      (2, "session-state-leak"), (3, "session-state-leak")]


def test_native_library_stem_is_no_symbol(tmp_path):
  """The port builds `_build/t2r_native-<hash>.so`: that stem is a file
  name, not a binding (the JAX rule's regex would read it as one)."""
  native_dir = tmp_path / "native"
  native_dir.mkdir()
  (native_dir / "x.cc").write_text(
      'extern "C" int64_t t2r_bound(void* h) { return 0; }\n')
  (native_dir / "__init__.py").write_text(
      '"""Built as `_build/t2r_native-<hash>.so`."""\n'
      'NAME = f"t2r_native-{digest}.so"\n'
      "lib.t2r_bound.restype = ctypes.c_int64\n")
  assert native_check.check_native_bindings(str(native_dir)) == []


def test_port_native_symbols_all_covered():
  native_dir = os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), "tensor2robot_tpu_torch", "native")
  exported = set()
  for name in os.listdir(native_dir):
    if name.endswith(".cc"):
      exported |= native_check.exported_symbols(os.path.join(native_dir,
                                                             name))
  assert {"t2r_crc32c", "t2r_reader_open", "t2r_parser_parse_batch",
          "t2r_stager_open", "t2r_stager_next_batch"} <= exported


@pytest.fixture(autouse=True)
def _clean_config():
  config.clear_config()
  jax_config.clear_config()
  yield
  config.clear_config()
  jax_config.clear_config()
