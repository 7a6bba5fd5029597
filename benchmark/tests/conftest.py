"""Settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the marker of the tests that need a CUDA card, and the
tiny cells the CPU tests run."""

from __future__ import annotations

import copy

import pytest

from benchmark import harness


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


TINY_CONFIG = {
    "mf_ml20m": dict(num_users=500, num_items=300, num_ratings=20000),
    "w2v_text8": dict(vocab_size=500, num_tokens=60000, dim=16),
}
TINY_CELL = {
    "mf_ml20m.sync": dict(local_batch=1024, trace_steps=4),
    "mf_ml20m.hot2048": dict(local_batch=1024, trace_steps=4, hot_items=32,
                             max_steps_per_call=4),
    "w2v_text8.pairs": dict(block_len=256, trace_steps=4,
                            max_steps_per_call=16),
    "w2v_text8.block": dict(block_len=256, trace_steps=4,
                            max_steps_per_call=16),
}


def tiny(name: str) -> tuple[dict, dict]:
    """The cell ``name`` and its configuration, cut to a CPU test's
    size."""
    cell, cfg = harness.load_cell(name)
    cell, cfg = copy.deepcopy(cell), copy.deepcopy(cfg)
    cell.update(TINY_CELL[name])
    cfg.update(TINY_CONFIG[cell["config"]])
    return cell, cfg


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
