"""Shared fixtures of portbench's tests: tiny sizes for the CPU, and the
`card` marker for tests that need an H100.

A card test decides inside the `card` fixture whether a CUDA device is
there, and skips otherwise: never while the module is imported. Run the
card tests on the chip from the repository root:

    python3 -m pytest portbench/tests -m card -q
"""

from __future__ import annotations

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
  sys.path.insert(0, str(ROOT))

TINY_SEQ = dict(obs_size=4, action_size=3, sequence_length=64,
                hidden_size=32, num_blocks=2, num_heads=4, head_dim=8,
                mlp_size=64)
TINY_CRITIC = dict(image_size=96, num_convs=[1, 1, 1])


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "card: needs a CUDA device (an H100); skipped without one")


def shrink(run) -> None:
  """A prepared run at a size the CPU runs in seconds: the same code
  paths, fewer rows, steps and robots."""
  model = run.config["model"]
  model.update(TINY_SEQ if "sequence_length" in model else TINY_CRITIC)
  traffic = run.traffic
  if traffic["driver"] == "train_step":
    traffic.update(batch_size=4, trace_seconds=0.2, enqueue_steps=2)
  else:
    traffic.update(robots=6, max_tick_batch=6, episode_ticks=64,
                   stagger_ticks=8, trace_seconds=0.2)
    run.config["serve"]["max_sessions"] = 6


@pytest.fixture
def card():
  import torch

  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
  import torch

  threads = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(threads)
