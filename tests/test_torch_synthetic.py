"""The port's synthetic screening library against the recipe it copies
(``examples/enrichment_example.py:make_library_batched``), its receptor
score tables against ``examples/panel_screening.py``, and the
profiling entry point's refusal to run without a CUDA device."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from rad_tpu_torch import profiling
from rad_tpu_torch.synthetic import (make_library, make_receptor_scores,
                                     make_receptor_tables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example_module(name="enrichment_example"):
    path = os.path.join(REPO, "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,n_bits,batch", [(4500, 256, 128),
                                            (300, 64, 1 << 16),
                                            (45_000, 64, 1 << 14)])
def test_make_library_matches_example_recipe(n, n_bits, batch):
    ref_packed, ref_scores = _example_module().make_library_batched(
        n, n_bits=n_bits, seed=3, batch=batch)
    packed, scores = make_library(n, n_bits=n_bits, seed=3, batch=batch)
    assert packed.dtype == np.uint32 and packed.shape == (n, n_bits // 32)
    np.testing.assert_array_equal(packed, ref_packed)
    np.testing.assert_array_equal(scores, ref_scores)


@pytest.mark.parametrize("rows,chunk_rows", [(1, 1), (37, 5), (64, 64),
                                             (100, 7)])
def test_chunked_mutation_draws_the_whole_draws(rows, chunk_rows):
    """The library's mutation step, drawn a chunk of rows at a time on
    threads, equals the two whole draws it replaces, and leaves the
    generator where they leave it, its buffered 32-bit half included."""
    from rad_tpu_torch.synthetic import _mutate

    child = (np.random.default_rng(5).random((rows, 96)) < 0.3).astype(
        np.uint8)
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    for g in (a, b):
        g.integers(0, 7, size=3)     # leaves a buffered 32-bit half
    want = np.where(a.random((rows, 96)) < 0.06,
                    a.random((rows, 96)) < 0.12, child).astype(np.uint8)
    got = _mutate(b, child, 0.06, 0.12, chunk_rows=chunk_rows)
    np.testing.assert_array_equal(got, want)
    assert b.bit_generator.state == a.bit_generator.state
    np.testing.assert_array_equal(b.integers(0, 1000, 50),
                                  a.integers(0, 1000, 50))


def test_receptor_tables_match_panel_example_recipe():
    """Array-equal to the example's tables: the same generator draws in
    the same order (centers from seed 9, noise from seed 100 + r)."""
    ref = _example_module("panel_screening").make_receptor_scores
    fps, _ = make_library(400, n_bits=128, seed=0)
    node_fps = fps[np.random.default_rng(2).permutation(len(fps))]
    tables = make_receptor_tables(node_fps, fps, 3)
    assert tables.shape == (3, 400) and tables.dtype == np.float32
    rng = np.random.default_rng(9)
    for r in range(3):
        center = fps[rng.integers(200, 400)]
        want = ref(node_fps, center, seed=100 + r)
        np.testing.assert_array_equal(tables[r], want)
        np.testing.assert_array_equal(
            make_receptor_scores(node_fps, center, seed=100 + r), want)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA device")
def test_profiling_refuses_without_cuda(capsys):
    assert profiling.main() == 1
    assert "no CUDA device" in capsys.readouterr().err
