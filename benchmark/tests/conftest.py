"""Shared pieces of the benchmark's CPU tests: a tiny CLIP configuration and
the cells of ``BENCHMARK.json`` cut to it (the widths and depths are the
tests', every other key the cell's own)."""

import pytest

from benchmark import spec

TINY = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
            vision_patch_size=16, context_length=77, vocab_size=49408,
            transformer_width=64, transformer_heads=1, transformer_layers=2,
            n_ctx=2, deep_prompt_depth=2, reference_chunk=4)
CELLS = {"train": "mudpt-vitb16.train-b384", "serve": "mudpt-vitb16.serve-mixed",
         "serve_int8": "mudpt-vitl14.serve-int8-mixed"}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def tiny_cell(kind: str, **config):
    """The cell of ``kind`` at the tiny configuration (``config`` overrides)."""
    c = spec.load(CELLS[kind])
    c.config = dict(TINY, **config)
    if c.traffic["mode"] == "train":
        c.traffic = dict(c.traffic, batch=8, n_cls=10)
    else:
        c.traffic = dict(c.traffic, n_cls=10, request_sizes=[2, 4], image_pool=16)
    return c


@pytest.fixture
def tiny():
    return tiny_cell
