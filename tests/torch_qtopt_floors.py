"""The rounding floors behind the tolerances of
`tests/test_torch_qtopt_models.py`, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_qtopt_floors.py

For Grasping44 at the tests' width (256x256, filters 16, convs (1, 1, 3)),
weights and batch_stats carried from the JAX model by `bridge.py`, it
prints one JSON line per case:

* f32, train mode, batch 2, seeds 0-3: how far the JAX package's and the
  port's logits and new running means lie from a float64 run of the
  port, and from each other (max |err| / max |ref|);
* the bf16 policy, train mode, batches 2 and 8, seeds 0-3: relative
  2-norm distances between the port's logits, the JAX model's run
  eagerly and jitted, and the JAX model's f32 logits.

Not a test: it takes a few minutes, and its numbers justify the tests'
tolerances.
"""

import json

import torch

import test_torch_qtopt_models as t
from tensor2robot_tpu_torch import bridge


def _f32_case(seed: int) -> dict:
  jax_model, model = t._grasping44_models()
  features = t._features(model, seed=seed)
  jax_state, state = t._states(jax_model, features, seed=seed)
  out, new, port_out, port_new = t._forward_both(jax_model, model, jax_state,
                                                 state, features, train=True)
  model.module.dtype = torch.float64
  with torch.no_grad():
    exact, exact_new = model.inference_network_fn(
        {k: v.double() for k, v in state.params.items()},
        {k: v.double() for k, v in state.mutable_state.items()},
        {"state/image": torch.from_numpy(features["state/image"]),
         "action/action": torch.from_numpy(
             features["action/action"]).double()}, "train", train=True)
  jax_new = bridge.mutable_state_from_flax(
      bridge._numpy_tree(new["batch_stats"]))
  means = [k for k in jax_new if k.endswith("running_mean")]

  def worst(got):
    return max(t._rel(got[k], exact_new[k]) for k in means)

  return {"case": "f32", "seed": seed,
          "logits_jax_vs_f64": t._rel(out["logits"], exact["logits"]),
          "logits_port_vs_f64": t._rel(port_out["logits"], exact["logits"]),
          "logits_port_vs_jax": t._rel(port_out["logits"], out["logits"]),
          "means_jax_vs_f64": worst(jax_new),
          "means_port_vs_f64": worst(port_new),
          "means_port_vs_jax": max(t._rel(port_new[k], jax_new[k])
                                   for k in means)}


def _bf16_case(batch: int, seed: int) -> dict:
  logits = {}
  for use_bfloat16 in (False, True):
    jax_model, model = t._grasping44_models(use_bfloat16)
    features = t._features(model, batch=batch, seed=seed)
    jax_state, state = t._states(jax_model, features)
    args = (jax_model, model, jax_state, state, features)
    jitted, _, port, _ = t._forward_both(*args, train=True)
    eager, _, _, _ = t._forward_both(*args, train=True, jit=False)
    logits[use_bfloat16] = (jitted["logits"], eager["logits"],
                            port["logits"])
  jitted, eager, port = logits[True]
  f32 = logits[False][0]
  return {"case": "bf16", "batch": batch, "seed": seed,
          "port_vs_jax_eager": t._rel_norm(port, eager),
          "port_vs_jax_jit": t._rel_norm(port, jitted),
          "jax_jit_vs_jax_eager": t._rel_norm(jitted, eager),
          "jax_eager_vs_jax_f32": t._rel_norm(eager, f32),
          "jax_jit_vs_jax_f32": t._rel_norm(jitted, f32)}


def main() -> None:
  torch.set_num_threads(4)
  for seed in range(4):
    print(json.dumps(_f32_case(seed)), flush=True)
  for batch in (2, 8):
    for seed in range(4):
      print(json.dumps(_bf16_case(batch, seed)), flush=True)


if __name__ == "__main__":
  main()
