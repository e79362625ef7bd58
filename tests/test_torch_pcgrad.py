"""PCGrad in the port against the JAX package, on the CPU.

* `pcgrad_combine` on the same three task gradients (a critic-shaped
  tree, bridged): per-leaf and flat projection, the JAX package's random
  projection order (its `jax.random.permutation` draws passed to the
  port as `permutations`), and allow and deny lists (surgery-exempt
  leaves get the raw sum): f32, 1e-6 relative to the largest entry.
* The lists' names: the JAX package matches regexes over `keystr` paths
  (`['conv2']['kernel']`), the port over its flat names (`conv2.weight`).
  Each JAX path mapped to the port's name by `bridge.state_dict_from_flax`,
  both sides keep the same leaves for each pair of lists.
* One PCGrad train step of the QT-Opt critic (Grasping44 at the tests'
  width, batch 2, f32, from a JAX state carried across by the bridge),
  with and without remat: the loss, the task losses and the global norm
  of the combined gradient 1e-5 relative; parameters, EMA and the
  momentum trace 1e-6 absolute, as in `test_torch_qtopt_train.py`.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import pcgrad as jax_pcgrad
from tensor2robot_tpu.parallel import train_step as jax_train_step
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.ops import pcgrad
from tensor2robot_tpu_torch.parallel import train_step
from tests import test_torch_qtopt_train as qt

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

COMBINE_RTOL = 1e-6
# (JAX regexes over keystr paths, the port's regexes over flat names)
LISTS = [
    ({"allowlist": [r"conv"]}, {"allowlist": [r"conv"]}),
    ({"denylist": [r"\['bias'\]"]}, {"denylist": [r"\.bias$"]}),
    ({"allowlist": [r"conv", r"fc\d"], "denylist": [r"\['conv2'\]"]},
     {"allowlist": [r"conv", r"fc\d"], "denylist": [r"^conv2\."]}),
]


def _tree_shapes():
  return {"conv1_1": {"kernel": (6, 6, 3, 4), "bias": (4,)},
          "conv2": {"kernel": (5, 5, 4, 4)},
          "conv2_bn": {"scale": (4,), "bias": (4,)},
          "fc0": {"kernel": (8, 5)},
          "logit": {"kernel": (5, 1), "bias": (1,)}}


def _task_trees(n, seed):
  rs = np.random.RandomState(seed)
  return [jax.tree_util.tree_map(
      lambda shape: rs.randn(*shape).astype(np.float32), _tree_shapes(),
      is_leaf=lambda x: isinstance(x, tuple)) for _ in range(n)]


def _jax_permutations(key, n):
  """The draws of JAX `pcgrad_combine` for each task i."""
  perms = []
  for _ in range(n):
    key, perm_key = jax.random.split(key)
    perms.append([int(j) for j in np.asarray(
        jax.random.permutation(perm_key, n))])
  return perms


def _assert_combined(got, want_tree):
  want = bridge.state_dict_from_flax(bridge._numpy_tree(want_tree))
  assert set(got) == set(want)
  scale = max(float(v.abs().max()) for v in want.values())
  for name, value in want.items():
    err = float((got[name] - value).abs().max()) / scale
    assert err <= COMBINE_RTOL, (name, err)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("keyed", [False, True])
def test_combine_matches_jax(flat, keyed):
  trees = _task_trees(3, seed=int(flat) + 2 * int(keyed))
  key = jax.random.PRNGKey(7) if keyed else None
  want = jax_pcgrad.pcgrad_combine([jax.tree_util.tree_map(jnp.asarray, t)
                                    for t in trees], key=key,
                                   use_flat_projection=flat)
  permutations = _jax_permutations(key, 3) if keyed else None
  if keyed:  # the draws leave the given order somewhere
    assert any(p != sorted(p) for p in permutations)
  got = pcgrad.pcgrad_combine(
      [bridge.state_dict_from_flax(t) for t in trees],
      permutations=permutations, use_flat_projection=flat)
  _assert_combined(got, want)


@pytest.mark.parametrize("lists", range(len(LISTS)))
@pytest.mark.parametrize("flat", [False, True])
def test_lists_match_jax(lists, flat):
  jax_lists, port_lists = LISTS[lists]
  trees = _task_trees(2, seed=10 + lists)
  want = jax_pcgrad.pcgrad_combine(
      [jax.tree_util.tree_map(jnp.asarray, t) for t in trees],
      use_flat_projection=flat, **jax_lists)
  got = pcgrad.pcgrad_combine([bridge.state_dict_from_flax(t)
                               for t in trees],
                              use_flat_projection=flat, **port_lists)
  _assert_combined(got, want)


@pytest.mark.parametrize("lists", range(len(LISTS)))
def test_list_names_map_through_the_bridge(lists):
  """Leaf i of the flax tree, filled with i + 1, bridges to the port leaf
  holding i + 1: both regex sets keep the same leaves."""
  jax_lists, port_lists = LISTS[lists]
  flat, _ = jax.tree_util.tree_flatten_with_path(
      _tree_shapes(), is_leaf=lambda x: isinstance(x, tuple))
  tagged = jax.tree_util.tree_unflatten(
      jax.tree_util.tree_structure(_tree_shapes(),
                                   is_leaf=lambda x: isinstance(x, tuple)),
      [np.full(shape, i + 1, np.float32)
       for i, (_, shape) in enumerate(flat)])
  port_names = {int(v.flatten()[0]) - 1: name
                for name, v in bridge.state_dict_from_flax(tagged).items()}
  assert sorted(port_names) == list(range(len(flat)))

  def kept(lists, name):
    deny, allow = lists.get("denylist"), lists.get("allowlist")
    if deny and any(re.search(p, name) for p in deny):
      return False
    return not allow or any(re.search(p, name) for p in allow)

  jax_kept = {i for i, (path, _) in enumerate(flat)
              if kept(jax_lists, jax.tree_util.keystr(path))}
  port_kept = {i for i, name in port_names.items() if kept(port_lists, name)}
  assert jax_kept == port_kept
  assert 0 < len(port_kept) < len(flat)


def test_single_task_and_bad_permutations():
  grads = bridge.state_dict_from_flax(_task_trees(1, seed=0)[0])
  assert pcgrad.pcgrad_combine([grads]) is grads
  with pytest.raises(ValueError, match="permutation"):
    pcgrad.pcgrad_combine([grads, grads], permutations=[[0, 1], [1, 1]])


@functools.lru_cache(maxsize=None)
def _jax_pcgrad_run():
  jax_model, model = qt._models(use_pcgrad=True)
  features, labels = qt._batch(model)
  initial = jax.jit(lambda rng, f: jax_train_step.create_train_state(
      jax_model, rng, f)[0])(jax.random.PRNGKey(0), features)
  stepped, metrics = jax_train_step.make_train_step(
      jax_model, donate=False)(initial, features, labels)
  return features, labels, initial, stepped, metrics


@pytest.mark.parametrize("remat", [False, True])
def test_pcgrad_step_matches_jax(remat):
  features, labels, initial, jax_state, jax_metrics = _jax_pcgrad_run()
  _, model = qt._models(use_pcgrad=True, remat=remat)
  state = bridge.train_state_from_jax(initial)
  new_state, metrics = train_step.make_train_step(model)(
      state, qt._torch(features), qt._torch(labels))
  assert set(metrics) == set(jax_metrics) == {
      "loss", "global_gradient_norm", "task_loss/bellman",
      "task_loss/q_regularizer"}
  for key in metrics:
    assert qt._rel(float(metrics[key]), float(jax_metrics[key])) \
        <= qt.LOSS_RTOL, key
  qt._assert_close(new_state.params, qt._state_dict(jax_state.params),
                   qt.PARAM_ATOL)
  qt._assert_close(new_state.ema_params, qt._state_dict(jax_state.ema_params),
                   qt.PARAM_ATOL)
  qt._assert_close(new_state.opt_state[1][0]["trace"],
                   qt._state_dict(jax_state.opt_state[1][0].trace),
                   qt.PARAM_ATOL)
  qt._assert_stats_close(new_state.mutable_state, jax_state.mutable_state)


def test_pcgrad_step_equals_combine_of_task_gradients():
  """The step's update is the optimizer on `pcgrad_combine` of the task
  gradients, each taken alone."""
  features, labels, initial, _, _ = _jax_pcgrad_run()
  _, model = qt._models(use_pcgrad=True)
  state = bridge.train_state_from_jax(initial)
  features, labels = qt._torch(features), qt._torch(labels)
  _, task_grads, _ = train_step.task_losses_and_grads(
      model, state.params, features, labels, state.mutable_state)
  combined = pcgrad.pcgrad_combine(task_grads)
  _, metrics = train_step.make_train_step(model)(state, features, labels)
  norm = torch.sqrt(sum(torch.sum(g * g) for g in combined.values()))
  assert float(metrics["global_gradient_norm"]) == pytest.approx(
      float(norm), rel=1e-6)
  # Each task's gradient alone, from its own backward pass.
  for i, task in enumerate(("bellman", "q_regularizer")):
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in state.params.items()}
    outputs, _ = model.inference_network_fn(leaves, state.mutable_state,
                                            features, "train", train=True)
    loss = model.model_task_losses_fn(features, labels, outputs,
                                      "train")[task]
    alone = torch.autograd.grad(loss, list(leaves.values()))
    for name, want in zip(leaves, alone):
      torch.testing.assert_close(task_grads[i][name], want, rtol=0, atol=0)
