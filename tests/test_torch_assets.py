"""The port's `t2r_assets` sidecar against the JAX package's, on the CPU.

* `Assets.to_json` is string-equal to the JAX package's for the critic's
  and the sequence policy's serving specs (and a spec that sets every
  field).
* The port's text-format `T2RAssets` (written by hand, no protobuf) is
  byte-identical to the JAX package's `write_assets_pbtxt` (protobuf's
  `text_format` over a runtime-built descriptor).
* Each package's `load_assets` reads the other's files, JSON and pbtxt,
  to equal specs and step; a missing JSON falls back to the pbtxt under
  `assets.extra/`.
"""

import numpy as np
import pytest
import torch

from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu.models import sequence_model as jax_sequence_model
from tensor2robot_tpu.research.qtopt import flagship as jax_flagship
from tensor2robot_tpu_torch import specs
from tensor2robot_tpu_torch.models import sequence_model
from tensor2robot_tpu_torch.research.qtopt import flagship

# The port's tests run in the same worker processes as the JAX suite;
# one torch thread keeps torch from starting its OpenMP and MKL thread
# pools beside XLA's CPU threads.
torch.set_num_threads(1)

SEQ_WIDTHS = dict(obs_size=4, action_size=2, sequence_length=8,
                  hidden_size=16, num_heads=2)


def _every_field(mod):
  feature = mod.SpecStruct()
  feature["state/image"] = mod.TensorSpec((472, 472, 3), np.uint8,
                                          name="image", data_format="jpeg")
  feature["action/action"] = mod.TensorSpec(
      (5,), np.float32, name='a "quoted"\tname\\é', is_optional=True,
      varlen_default_value=0.5)
  feature["x/y"] = mod.TensorSpec((None, 3), np.int64, dataset_key="d",
                                  is_extracted=True, is_sequence=True)
  label = mod.SpecStruct()
  label["reward"] = mod.TensorSpec((1,), np.float32)
  return mod.Assets(feature_spec=feature, label_spec=label, global_step=30)


def _serving(mod, model):
  return mod.Assets(
      feature_spec=model.preprocessor.get_in_feature_specification(
          "predict"),
      label_spec=mod.flatten_spec_structure(
          model.get_label_specification("predict")),
      global_step=7)


CASES = {
    "critic": lambda: (
        _serving(jax_specs, jax_flagship.make_flagship_model("cpu")),
        _serving(specs, flagship.make_flagship_model("cpu"))),
    "sequence_policy": lambda: (
        _serving(jax_specs, jax_sequence_model.SequenceRegressionModel(
            device_type="cpu", **SEQ_WIDTHS)),
        _serving(specs, sequence_model.SequenceRegressionModel(
            **SEQ_WIDTHS))),
    "every_field": lambda: (_every_field(jax_specs), _every_field(specs)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_json_is_string_equal_to_jax(case):
  jax_assets, assets = CASES[case]()
  assert assets.to_json() == jax_assets.to_json()


@pytest.mark.parametrize("case", sorted(CASES))
def test_pbtxt_is_byte_identical_to_jax(case, tmp_path):
  jax_assets, assets = CASES[case]()
  jax_specs.write_assets_pbtxt(jax_assets, str(tmp_path / "jax.pbtxt"))
  specs.write_assets_pbtxt(assets, str(tmp_path / "port.pbtxt"))
  want = (tmp_path / "jax.pbtxt").read_bytes()
  assert (tmp_path / "port.pbtxt").read_bytes() == want
  assert want.startswith(b"feature_spec {\n")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["t2r_assets.json", "t2r_assets.pbtxt"])
def test_each_package_reads_the_others_files(case, name, tmp_path):
  jax_assets, assets = CASES[case]()
  write = {"t2r_assets.json": (jax_specs.write_assets, specs.write_assets),
           "t2r_assets.pbtxt": (jax_specs.write_assets_pbtxt,
                                specs.write_assets_pbtxt)}[name]
  write[0](jax_assets, str(tmp_path / "jax" / name))
  write[1](assets, str(tmp_path / "port" / name))
  from_jax = specs.load_assets(str(tmp_path / "jax" / name))
  from_port = jax_specs.load_assets(str(tmp_path / "port" / name))
  for got, want in ((from_jax, assets), (from_port, jax_assets)):
    assert got.global_step == want.global_step
    for field in ("feature_spec", "label_spec"):
      got_flat = {k: v.to_dict() for k, v in getattr(got, field).items()}
      want_flat = {k: v.to_dict() for k, v in getattr(want, field).items()}
      if name.endswith(".pbtxt"):  # the proto has no is_sequence field
        for d in want_flat.values():
          d.pop("is_sequence", None)
      assert got_flat == want_flat


def test_load_falls_back_to_the_pbtxt_under_assets_extra(tmp_path):
  _, assets = CASES["every_field"]()
  specs.write_assets_pbtxt(assets, str(tmp_path / "assets.extra" /
                                       specs.PBTXT_ASSET_FILENAME))
  loaded = specs.load_assets(str(tmp_path / specs.ASSET_FILENAME))
  assert loaded.global_step == 30
  assert loaded.feature_spec["state/image"] == assets.feature_spec[
      "state/image"]
  with pytest.raises(ValueError, match="unknown field"):
    specs.assets_from_pbtxt("feature_spec { bogus: 1 }")
