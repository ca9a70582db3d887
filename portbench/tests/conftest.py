"""Tiny cells for the CPU: each real cell with its configuration cut to a
few hundred thousand parameters and its traffic to a few requests or
steps. The card's tests are marked `cuda` and skip without one."""

import copy
import importlib.util
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

TINY_LM = dict(model_dim=64, num_heads=4, num_kv_heads=2, num_layers=2,
               expert_hidden=128, ffn_hidden=128, num_local_experts=4,
               vocab_size=256)
TINY_MOE = dict(model_dim=64, expert_hidden=32, num_local_experts=8,
                top_k=4)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU")


def run_module():
    spec = importlib.util.spec_from_file_location(
        "portbench_run_under_test", ROOT / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_cell(name):
    """The cell `name` at a CPU size."""
    cell = copy.deepcopy(harness.cell(name))
    port, p = cell["config_data"]["port"], cell["params"]
    if "num_layers" in port:
        port.update(TINY_LM)
    else:
        port.update(TINY_MOE)
    if cell["generator"] == "closed_loop_serve":
        p.update(clients=8, slots=8, prompt_len=[8, 40], output_len=[8, 24],
                 max_len=128, chunk=4)
    else:
        p.update(batch=2, seq=64)
    return cell


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs a cell on the card")
    return torch.device("cuda", 0)
