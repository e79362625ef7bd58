"""The MDN head and the MAF decoder in the port against the JAX package, on
the CPU.

`layers/mdn.py`: `MDNHead` (flax's parameters carried across by
`bridge.py`), `mdn_log_prob` and its gradients, `mdn_approximate_mode`
(on logits whose top two are at least 1e-3 apart, so no near-tie can
pick another component), `mdn_sample` on the JAX package's own Gumbel
and normal draws, `MDNDecoder`, the float32 output under bfloat16
weights (JAX rounds the head's output to float32 even under x64; the
port keeps at least float32, and the float64 case widens JAX's cast,
`torch_model_parity.widen_float32_casts`).

`research/vrgripper/maf.py`: `MADE`'s autoregressive property in the
port (no gradient from inputs >= d into output d), `MADE` and
`MAFDecoder.log_prob` with and without a context, and `sample` on the
JAX package's normal draw.

Tolerances, of max(1, max |ref|): float64 (JAX under `jax.enable_x64`)
1e-10, values and gradients; float32 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers import mdn as jax_mdn
from tensor2robot_tpu.research.vrgripper import maf as jax_maf
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.layers import mdn
from tensor2robot_tpu_torch.research.vrgripper import maf
from tests import torch_model_parity as parity

torch.set_num_threads(1)

F64_TOL = 1e-10
F32_TOL = 1e-5
MODE_GAP = 1e-3
DTYPES = {"float64": (jnp.float64, torch.float64, F64_TOL),
          "float32": (jnp.float32, torch.float32, F32_TOL)}


def _load(module, flax_params, dtype):
  """The port module on the bridged flax params, cast to `dtype`."""
  module = module.to(dtype)
  module.load_state_dict({k: v.to(dtype) for k, v in
                          parity.bridged(flax_params).items()})
  return module


def _mdn_params(seed, batch=6, k=3, d=2):
  rng = np.random.RandomState(seed)
  return (rng.randn(batch, k), rng.randn(batch, k, d),
          np.exp(0.3 * rng.randn(batch, k, d)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mdn_head(dtype, monkeypatch):
  jdt, tdt, tol = DTYPES[dtype]
  x = np.random.RandomState(0).randn(4, 3, 5)
  head = jax_mdn.MDNHead(num_components=3, output_size=2)
  params = parity.randomized(
      head.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32))["params"],
      1)
  if dtype == "float64":
    parity.widen_float32_casts(monkeypatch, jax_mdn)
  with jax.enable_x64(dtype == "float64"):
    want = head.apply({"params": parity.cast_tree(params, jdt)},
                      jnp.asarray(x, jdt))
    want = [np.asarray(w) for w in want]
  port = _load(mdn.MDNHead(5, 3, 2), params, tdt)
  got = port(torch.from_numpy(x).to(tdt))
  for g, w in zip(got, want):
    assert parity.scaled_err(g, w) <= tol
  assert all(t.dtype == tdt for t in got)


def test_mdn_head_clamps_log_scales_before_the_exp():
  head = mdn.MDNHead(1, 1, 1)
  with torch.no_grad():
    head.mdn_proj.weight.zero_()
    head.mdn_proj.bias.copy_(torch.tensor([0.0, 0.0, -50.0]))
  scales = head(torch.zeros(1, 1)).scales
  assert float(scales.detach()) == pytest.approx(np.exp(-7.0), rel=1e-6)


def test_mdn_head_bf16_weights_give_float32():
  head = mdn.MDNHead(5, 3, 2).to(torch.bfloat16)
  out = head(torch.randn(4, 5, dtype=torch.bfloat16))
  assert all(t.dtype == torch.float32 for t in out)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mdn_log_prob_and_gradients(dtype):
  jdt, tdt, tol = DTYPES[dtype]
  logits, means, scales = _mdn_params(0)
  value = np.random.RandomState(1).randn(6, 2)
  with jax.enable_x64(dtype == "float64"):
    def jax_nll(lg, mu, sc):
      return -jax_mdn.mdn_log_prob(jax_mdn.MDNParams(lg, mu, sc),
                                   jnp.asarray(value, jdt)).sum()
    args = [jnp.asarray(a, jdt) for a in (logits, means, scales)]
    want = np.asarray(jax_mdn.mdn_log_prob(jax_mdn.MDNParams(*args),
                                           jnp.asarray(value, jdt)))
    want_grads = [np.asarray(g) for g in
                  jax.grad(jax_nll, argnums=(0, 1, 2))(*args)]
  tensors = [torch.tensor(a, dtype=tdt, requires_grad=True)
             for a in (logits, means, scales)]
  got = mdn.mdn_log_prob(mdn.MDNParams(*tensors),
                         torch.tensor(value, dtype=tdt))
  grads = torch.autograd.grad(-got.sum(), tensors)
  assert parity.scaled_err(got, want) <= tol
  for g, w in zip(grads, want_grads):
    assert parity.scaled_err(g, w) <= tol


def test_mdn_approximate_mode_away_from_ties():
  logits, means, scales = _mdn_params(2, batch=32)
  top2 = np.sort(logits, axis=-1)[:, -2:]
  keep = (top2[:, 1] - top2[:, 0]) >= MODE_GAP
  assert keep.sum() >= 24
  logits, means, scales = logits[keep], means[keep], scales[keep]
  with jax.enable_x64(True):
    want = np.asarray(jax_mdn.mdn_approximate_mode(jax_mdn.MDNParams(
        jnp.asarray(logits), jnp.asarray(means), jnp.asarray(scales))))
  got = mdn.mdn_approximate_mode(mdn.MDNParams(
      *(torch.from_numpy(a) for a in (logits, means, scales))))
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mdn_sample_on_injected_draws(seed):
  logits, means, scales = _mdn_params(seed)
  key = jax.random.PRNGKey(seed)
  with jax.enable_x64(True):
    params = jax_mdn.MDNParams(jnp.asarray(logits), jnp.asarray(means),
                               jnp.asarray(scales))
    want = np.asarray(jax_mdn.mdn_sample(key, params))
    key_cat, key_norm = jax.random.split(key)
    gumbel = np.asarray(jax.random.gumbel(key_cat, logits.shape))
    normal = np.asarray(jax.random.normal(key_norm, (6, 2)))
  got = mdn.mdn_sample(
      mdn.MDNParams(*(torch.from_numpy(a) for a in (logits, means, scales))),
      torch.tensor(gumbel), torch.tensor(normal))
  assert parity.scaled_err(got, want) <= F64_TOL


def test_draw_mdn_sample_shapes_and_components():
  params = mdn.MDNParams(*(torch.from_numpy(a).float()
                           for a in _mdn_params(3, batch=2000, k=2, d=2)))
  params = params._replace(logits=torch.tensor([[0.0, np.log(3.0)]]).expand(
      2000, 2))
  gumbel, normal = mdn.draw_mdn_sample(torch.Generator().manual_seed(0),
                                       params)
  assert gumbel.shape == (2000, 2) and normal.shape == (2000, 2)
  picked = torch.argmax(params.logits + gumbel, dim=-1).float().mean()
  assert abs(float(picked) - 0.75) < 0.05  # P(component 1) = 3 / 4
  sample = mdn.mdn_sample(params, gumbel, normal)
  assert sample.shape == (2000, 2) and torch.isfinite(sample).all()


def test_mdn_decoder():
  x = np.random.RandomState(4).randn(5, 6).astype(np.float32)
  target = np.random.RandomState(5).randn(5, 2).astype(np.float32)
  decoder = jax_mdn.MDNDecoder(num_components=4, output_size=2)
  variables = decoder.init(jax.random.PRNGKey(0), jnp.asarray(x))
  params = parity.randomized(variables["params"], 2)
  want_mode, want_params = decoder.apply({"params": params}, jnp.asarray(x))
  want_loss = jax_mdn.MDNDecoder.loss(want_params, jnp.asarray(target))
  port = _load(mdn.MDNDecoder(6, 4, 2), params, torch.float32)
  got_mode, got_params = port(torch.from_numpy(x))
  logits = np.asarray(want_params.logits)
  top2 = np.sort(logits, axis=-1)[:, -2:]
  assert ((top2[:, 1] - top2[:, 0]) >= MODE_GAP).all()
  assert parity.scaled_err(got_mode, want_mode) <= F32_TOL
  assert parity.scaled_err(
      mdn.MDNDecoder.loss(got_params, torch.from_numpy(target)),
      want_loss) <= F32_TOL
  assert set(mdn.as_outputs(got_params)) == {
      "mdn_params/logits", "mdn_params/means", "mdn_params/scales"}
  rebuilt = mdn.from_outputs(mdn.as_outputs(got_params))
  assert all(a is b for a, b in zip(rebuilt, got_params))


# -- MAF -------------------------------------------------------------------------


def _made_params(dim, hidden, context=None, seed=0):
  x = jnp.zeros((5, dim), jnp.float32)
  made = jax_maf.MADE(dim=dim, hidden=hidden)
  params = made.init(jax.random.PRNGKey(seed), x, context)["params"]
  return made, parity.randomized(params, seed + 1)


def test_made_is_autoregressive_in_the_port():
  dim = 4
  _, params = _made_params(dim, 32)
  port = _load(maf.MADE(dim, 32), params, torch.float64)
  x = torch.randn(1, dim, dtype=torch.float64, requires_grad=True)
  for d in range(dim):
    for out in port(x):
      (grad,) = torch.autograd.grad(out[0, d], x, retain_graph=True)
      assert (grad[0, d:] == 0).all(), (d, grad)
      if d > 0:  # the earlier inputs do reach it
        assert (grad[0, :d] != 0).any()


@pytest.mark.parametrize("with_context", [False, True])
def test_made_matches_jax(with_context):
  rng = np.random.RandomState(3)
  x = rng.randn(5, 3)
  ctx = rng.randn(5, 8) if with_context else None
  made, params = _made_params(
      3, 16, None if ctx is None else jnp.asarray(ctx, jnp.float32))
  assert set(bridge.state_dict_from_flax(params)) >= {
      "w1", "b1", "w_shift", "w_scale", "b_shift", "b_scale"}
  with jax.enable_x64(True):
    want = made.apply({"params": parity.cast_tree(params, jnp.float64)},
                      jnp.asarray(x),
                      None if ctx is None else jnp.asarray(ctx))
  port = _load(maf.MADE(3, 16, context_size=8 if with_context else 0),
               params, torch.float64)
  got = port(torch.from_numpy(x),
             None if ctx is None else torch.from_numpy(ctx))
  for g, w in zip(got, want):
    assert parity.scaled_err(g, np.asarray(w)) <= F64_TOL


def _flow(dim, with_context, seed=0):
  flow = jax_maf.MAFDecoder(dim=dim, num_blocks=3, hidden=16)
  ctx = jnp.ones((5, 8), jnp.float32) if with_context else None
  params = flow.init(jax.random.PRNGKey(seed), jnp.zeros((5, dim)),
                     ctx)["params"]
  return flow, parity.randomized(params, seed + 7)


@pytest.mark.parametrize("with_context", [False, True])
def test_maf_log_prob_and_gradients(with_context):
  rng = np.random.RandomState(4)
  x = rng.randn(5, 3)
  ctx = rng.randn(5, 8) if with_context else None
  flow, params = _flow(3, with_context)
  with jax.enable_x64(True):
    p64 = parity.cast_tree(params, jnp.float64)

    def total(xx):
      return flow.apply({"params": p64}, xx,
                        None if ctx is None else jnp.asarray(ctx)).sum()
    want = np.asarray(flow.apply({"params": p64}, jnp.asarray(x),
                                 None if ctx is None else jnp.asarray(ctx)))
    want_grad = np.asarray(jax.grad(total)(jnp.asarray(x)))
  port = _load(maf.MAFDecoder(3, num_blocks=3, hidden=16,
                              context_size=8 if with_context else 0),
               params, torch.float64)
  xt = torch.tensor(x, requires_grad=True)
  got = port.log_prob(xt, None if ctx is None else torch.from_numpy(ctx))
  (grad,) = torch.autograd.grad(got.sum(), xt)
  assert parity.scaled_err(got, want) <= F64_TOL
  assert parity.scaled_err(grad, want_grad) <= F64_TOL


@pytest.mark.parametrize("with_context", [False, True])
def test_maf_sample_on_injected_draws(with_context):
  ctx = (np.random.RandomState(5).randn(5, 8) if with_context else None)
  flow, params = _flow(3, with_context, seed=1)
  key = jax.random.PRNGKey(9)
  with jax.enable_x64(True):
    p64 = parity.cast_tree(params, jnp.float64)
    want = np.asarray(flow.apply(
        {"params": p64}, method=flow.sample, key=key,
        context=None if ctx is None else jnp.asarray(ctx),
        batch_shape=(5,)))
    normal = np.asarray(jax.random.normal(key, (5, 3)))
  port = _load(maf.MAFDecoder(3, num_blocks=3, hidden=16,
                              context_size=8 if with_context else 0),
               params, torch.float64)
  got = port.sample(torch.tensor(normal),
                    None if ctx is None else torch.from_numpy(ctx))
  assert parity.scaled_err(got, want) <= F64_TOL
