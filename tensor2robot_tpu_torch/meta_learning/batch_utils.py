"""Task-batch reshaping utilities for meta-learning.

Counterpart of `tensor2robot_tpu.meta_learning.batch_utils`:
`flatten_batch_examples` / `unflatten_batch_examples` merge and split
the [task, samples_per_task] leading dims, `multi_batch_apply` runs a
one-batch-dim function over N leading dims, and `split_train_val` splits
the samples dim. Leaves are torch tensors or numpy arrays; trees are
mappings (a `SpecStruct` stays one), tuples and lists.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence, Tuple

from tensor2robot_tpu_torch import specs as specs_lib

__all__ = ["flatten_batch_examples", "unflatten_batch_examples",
           "multi_batch_apply", "split_train_val", "map_leaves", "leaves"]


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
  """`fn` applied to every leaf of a tree of mappings, tuples and lists."""
  if isinstance(tree, specs_lib.SpecStruct):
    return specs_lib.SpecStruct({k: map_leaves(fn, v)
                                 for k, v in tree.items()})
  if isinstance(tree, Mapping):
    return {k: map_leaves(fn, v) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(map_leaves(fn, v) for v in tree)
  return fn(tree)


def leaves(tree: Any) -> list:
  """The leaves of a tree, in its order."""
  if isinstance(tree, Mapping):
    return [x for v in tree.values() for x in leaves(v)]
  if isinstance(tree, (tuple, list)):
    return [x for v in tree for x in leaves(v)]
  return [tree]


def flatten_batch_examples(tree: Any, num_batch_dims: int = 2) -> Any:
  """Merges the first `num_batch_dims` dims of every leaf."""

  def _flat(x):
    shape = tuple(x.shape)
    if len(shape) < num_batch_dims:
      raise ValueError(
          f"Leaf rank {len(shape)} < num_batch_dims {num_batch_dims}")
    merged = 1
    for d in shape[:num_batch_dims]:
      merged *= d
    return x.reshape((merged,) + shape[num_batch_dims:])

  return map_leaves(_flat, tree)


def unflatten_batch_examples(tree: Any,
                             leading_shape: Sequence[int]) -> Any:
  """Splits the leading dim of every leaf back into `leading_shape`."""
  leading = tuple(int(d) for d in leading_shape)
  return map_leaves(lambda x: x.reshape(leading + tuple(x.shape[1:])), tree)


def multi_batch_apply(fn: Callable, num_batch_dims: int, *args, **kwargs):
  """Applies `fn` (expecting one batch dim) over N leading dims."""
  args_leaves = leaves(args)
  if not args_leaves:
    return fn(*args, **kwargs)
  leading = tuple(args_leaves[0].shape[:num_batch_dims])
  flat_args = flatten_batch_examples(args, num_batch_dims)
  out = fn(*flat_args, **kwargs)
  return unflatten_batch_examples(out, leading)


def split_train_val(tree: Any, num_train: int) -> Tuple[Any, Any]:
  """Splits the per-task samples dim of [task, samples, ...] leaves into
  ([task, num_train, ...], [task, rest, ...])."""
  train = map_leaves(lambda x: x[:, :num_train], tree)
  val = map_leaves(lambda x: x[:, num_train:], tree)
  return train, val
