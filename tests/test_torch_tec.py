"""The port's TEC module against the JAX package's, on the CPU.

`layers/tec.py`, the whole module: `reduce_temporal_embeddings`,
`EmbedEpisode`, `EmbedConditionImages` (spatial softmax with its fc
head, and the spatial map with 1x1 convs), `TemporalConvEmbedding`,
`cosine_distance_matrix`, `npairs_loss` and `triplet_semihard_loss`
(cosine and euclidean, with their gradients). flax init, leaves redrawn
at random so zero biases show, carried across by `bridge.py`.

Tolerances, of max(1, max |ref|): float64 (JAX under `jax.enable_x64`)
1e-10, the triplet loss and its gradients included, on embeddings whose
semihard selection has no near-ties (checked: every distance the mining
compares is at least 1e-6 from the next); float32 outputs 1e-5,
gradients 1e-4 x max(1, max |g|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers import tec as jax_tec
from tensor2robot_tpu_torch import bridge
from tensor2robot_tpu_torch.layers import tec
from tests.torch_model_parity import randomized as _randomized
from tests.torch_model_parity import scaled_err as _err

torch.set_num_threads(1)

F64_TOL = 1e-10
F32_TOL = 1e-5
GRAD_TOL = 1e-4


def _module_pair(jax_module, port_module, x, seed=0, dtype=np.float32,
                 port_output=lambda out: out):
  """(port output, JAX output) in `dtype` on redrawn flax params."""
  variables = jax_module.init(jax.random.PRNGKey(seed),
                              jnp.asarray(x, jnp.float32))
  params = _randomized(jax.tree_util.tree_map(np.asarray,
                                              variables["params"]), seed + 1)
  with jax.enable_x64(dtype == np.float64):
    want = np.asarray(jax_module.apply(
        {"params": jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                          params)}, jnp.asarray(x, dtype)))
  tdtype = torch.float64 if dtype == np.float64 else torch.float32
  state = {k: v.to(tdtype) for k, v in
           bridge.state_dict_from_flax(params).items()}
  assert set(state) == set(dict(port_module.named_parameters()))
  got = port_output(torch.func.functional_call(
      port_module, state, (torch.tensor(np.asarray(x), dtype=tdtype),)))
  return got, want


@pytest.mark.parametrize("reduction", ["mean", "final", "max"])
def test_reduce_temporal_embeddings(reduction):
  x = np.random.RandomState(0).randn(3, 5, 4)
  want = jax_tec.reduce_temporal_embeddings(jnp.asarray(x, jnp.float32),
                                            reduction)
  got = tec.reduce_temporal_embeddings(torch.tensor(x, dtype=torch.float32),
                                       reduction)
  assert _err(got, want) <= F32_TOL


def test_reduce_temporal_embeddings_rejects_unknown_reduction():
  with pytest.raises(ValueError, match="median"):
    tec.reduce_temporal_embeddings(torch.zeros(1, 2, 3), "median")


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64_TOL),
                                       (np.float32, F32_TOL)])
@pytest.mark.parametrize("reduction,normalize", [("mean", True),
                                                 ("max", False)])
def test_embed_episode(dtype, tol, reduction, normalize):
  x = np.random.RandomState(1).randn(3, 4, 6)
  got, want = _module_pair(
      jax_tec.EmbedEpisode(embedding_size=5, hidden_size=7,
                           reduction=reduction, normalize=normalize),
      tec.EmbedEpisode(6, embedding_size=5, hidden_size=7,
                       reduction=reduction, normalize=normalize),
      x, dtype=dtype)
  assert got.shape == (3, 5)
  assert _err(got, want) <= tol


# The spatial softmax runs float32 in JAX even under x64 (and the port's
# grid is a float32 linspace), so its paths are held in float32 only.
@pytest.mark.parametrize("dtype,tol,spatial_softmax,fc_layers", [
    (np.float32, F32_TOL, True, (6, 3)), (np.float32, F32_TOL, True, None),
    (np.float32, F32_TOL, False, (6, 3)),
    (np.float64, F64_TOL, False, (6, 3))])
def test_embed_condition_images(dtype, tol, spatial_softmax, fc_layers):
  images = np.random.RandomState(2).rand(2, 12, 14, 3)
  kw = dict(filters=(4, 3), kernel_sizes=(5, 3), strides=(2, 1))
  got, want = _module_pair(
      jax_tec.EmbedConditionImages(fc_layers=fc_layers,
                                   use_spatial_softmax=spatial_softmax, **kw),
      tec.EmbedConditionImages(3, fc_layers=fc_layers,
                               use_spatial_softmax=spatial_softmax, **kw),
      images, dtype=dtype, port_output=lambda out: out[0])
  assert _err(got, want) <= tol


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64_TOL),
                                       (np.float32, F32_TOL)])
@pytest.mark.parametrize("steps", [4, 12])
def test_temporal_conv_embedding(dtype, tol, steps):
  x = np.random.RandomState(3).randn(2, steps, 5)
  got, want = _module_pair(
      jax_tec.TemporalConvEmbedding(output_size=3, conv1d_layers=(6, 4),
                                    fc_hidden_layers=(7,)),
      tec.TemporalConvEmbedding(5, 3, conv1d_layers=(6, 4),
                                fc_hidden_layers=(7,)),
      x, dtype=dtype)
  assert got.shape == (2, 3)
  assert _err(got, want) <= tol


def test_cosine_distance_matrix():
  rng = np.random.RandomState(4)
  a, b = rng.randn(4, 3), rng.randn(5, 3)
  with jax.enable_x64(True):
    want = jax_tec.cosine_distance_matrix(jnp.asarray(a), jnp.asarray(b))
  got = tec.cosine_distance_matrix(torch.tensor(a), torch.tensor(b))
  assert got.shape == (4, 5)
  assert _err(got, want) <= F64_TOL


def _loss_and_grads_both(jax_fn, port_fn, arrays, dtype):
  """(port loss, JAX loss, port grads, JAX grads) with respect to every
  array."""
  with jax.enable_x64(dtype == np.float64):
    jarrays = [jnp.asarray(a, dtype) for a in arrays]
    want, want_grads = jax.value_and_grad(
        lambda *xs: jax_fn(*xs), argnums=tuple(range(len(arrays))))(*jarrays)
  tdtype = torch.float64 if dtype == np.float64 else torch.float32
  tarrays = [torch.tensor(a, dtype=tdtype, requires_grad=True)
             for a in arrays]
  got = port_fn(*tarrays)
  got_grads = torch.autograd.grad(got, tarrays)
  return got, np.asarray(want), got_grads, [np.asarray(g)
                                            for g in want_grads]


@pytest.mark.parametrize("dtype,tol,grad_tol", [
    (np.float64, F64_TOL, F64_TOL), (np.float32, F32_TOL, GRAD_TOL)])
@pytest.mark.parametrize("with_labels", [False, True])
def test_npairs_loss(dtype, tol, grad_tol, with_labels):
  rng = np.random.RandomState(5)
  anchor, positive = rng.randn(6, 4), rng.randn(6, 4)
  labels = np.array([0, 1, 1, 2, 0, 3]) if with_labels else None
  got, want, got_grads, want_grads = _loss_and_grads_both(
      lambda a, p: jax_tec.npairs_loss(
          a, p, None if labels is None else jnp.asarray(labels)),
      lambda a, p: tec.npairs_loss(
          a, p, None if labels is None else torch.tensor(labels)),
      [anchor, positive], dtype)
  assert _err(got, want) <= tol
  for g, w in zip(got_grads, want_grads):
    assert _err(g, w) <= grad_tol


def _no_near_ties(dist: np.ndarray, labels: np.ndarray, margin=1e-6) -> bool:
  """Every anchor's distances to distinct others differ by at least
  `margin`, so the semihard selection is not decided by rounding."""
  for i in range(len(labels)):
    row = np.sort(np.delete(dist[i], i))
    if np.diff(row).min() < margin:
      return False
  return True


@pytest.mark.parametrize("distance", ["cosine", "euclidean"])
@pytest.mark.parametrize("dtype,tol,grad_tol", [
    (np.float64, F64_TOL, F64_TOL), (np.float32, F32_TOL, GRAD_TOL)])
def test_triplet_semihard_loss(distance, dtype, tol, grad_tol):
  rng = np.random.RandomState(6)
  labels = np.array([0, 0, 1, 1, 2, 2, 3, 0])
  embeddings = rng.randn(8, 5)
  dist = np.asarray(tec.cosine_distance_matrix(
      torch.tensor(embeddings), torch.tensor(embeddings)) if distance ==
      "cosine" else np.linalg.norm(embeddings[:, None] - embeddings[None],
                                   axis=-1))
  assert _no_near_ties(dist, labels)
  got, want, got_grads, want_grads = _loss_and_grads_both(
      lambda e: jax_tec.triplet_semihard_loss(
          e, jnp.asarray(labels), margin=0.7, distance=distance),
      lambda e: tec.triplet_semihard_loss(
          e, torch.tensor(labels), margin=0.7, distance=distance),
      [embeddings], dtype)
  assert float(want) > 0
  assert _err(got, want) <= tol
  assert _err(got_grads[0], want_grads[0]) <= grad_tol


def test_triplet_falls_back_to_the_easiest_negative():
  # Anchor 0's positive (1) is farther than every negative: no semihard
  # negative, so the farthest negative is used.
  embeddings = torch.tensor([[0.0, 0.0], [5.0, 0.0], [1.0, 0.0],
                             [0.0, 2.0]], dtype=torch.float64)
  labels = torch.tensor([0, 0, 1, 2])
  loss = tec.triplet_semihard_loss(embeddings, labels, margin=1.0,
                                   distance="euclidean")
  with jax.enable_x64(True):
    want = jax_tec.triplet_semihard_loss(jnp.asarray(embeddings.numpy()),
                                         jnp.asarray(labels.numpy()),
                                         margin=1.0, distance="euclidean")
  # Pair (0, 1): 5 + 1 - 2 = 4 (negatives at 1 and 2, the farther one);
  # pair (1, 0): negative 3 at sqrt(29) > 5 is semihard: 6 - sqrt(29).
  expected = (4.0 + max(6.0 - np.sqrt(29.0), 0.0)) / 2
  assert abs(float(loss) - expected) <= 1e-12
  assert _err(loss, want) <= F64_TOL
